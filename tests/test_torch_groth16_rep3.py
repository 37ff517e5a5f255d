"""The slice as a whole: a 3-party REP3 co-Groth16 proof in the port
against the JAX package, every seed pinned, tolerance 0.

Both packages split the same witness with the same dealer seed, the three
parties exchange pinned PRF seeds, and the proofs must be equal point for
point and verify under both packages' pairing verifiers.
"""

import threading

import cocircom_tpu.mpc.rep3 as ref_rep3
import cocircom_tpu_torch.mpc.rep3 as port_rep3
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.io.r1cs import R1CS as RefR1CS
from cocircom_tpu.io.witness import Witness as RefWitness
from cocircom_tpu.io.zkey import read_groth16_zkey as ref_read_zkey
from cocircom_tpu.mpc.runner import run_parties as ref_run_parties
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.snark.groth16 import CoGroth16 as RefCoGroth16
from cocircom_tpu.snark.groth16_verify import verify_groth16 as ref_verify
from cocircom_tpu.snark.setup import groth16_setup as ref_setup
from cocircom_tpu.snark.shared import split_witness_rep3 as ref_split_rep3
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.io.witness import Witness
from cocircom_tpu_torch.io.zkey import read_groth16_zkey
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.ops.field import ints_to_limbs_np
from cocircom_tpu_torch.snark.groth16 import (SPAN_ENDGAME, SPAN_MSM_HL, SPAN_WITNESS_MAP,
                                              CoGroth16)
from cocircom_tpu_torch.snark.groth16_verify import verify_groth16
from cocircom_tpu_torch.snark.shared import split_witness_rep3
from cocircom_tpu_torch.utils.trace import Tracer
from torch_port_util import multiplier_chain, same, small_msm_engines

SEEDS = [bytes([0x10 + i]) * 32 for i in range(3)]


def _pinned_seed():
    return SEEDS[int(threading.current_thread().name.split("-")[-1])]


def _named(run, fn):
    def wrapped(i, net):
        threading.current_thread().name = f"party-{i}"
        return fn(i, net)

    return run(wrapped, 3)


def test_rep3_proof_equals_reference_and_verifies(monkeypatch):
    restore = small_msm_engines(monkeypatch)
    try:
        _run(monkeypatch)
    finally:
        restore()


def _run(monkeypatch):
    monkeypatch.setattr(ref_rep3, "fresh_seed", _pinned_seed)
    monkeypatch.setattr(port_rep3, "fresh_seed", _pinned_seed)
    r1cs, vals = multiplier_chain(BN254, RefR1CS, 12, 5)
    zkey_bytes, vk = ref_setup(r1cs, seed=b"torch-port-rep3")
    publics = [vals[1], vals[2]]

    # ---- the port ----
    zk = read_groth16_zkey(zkey_bytes, device="cpu")
    wit = Witness(PBN254, len(vals), ints_to_limbs_np(vals, 8))
    shares = split_witness_rep3(wit, 2, seed=99, device="cpu")
    tracer = Tracer(enabled=True)

    def party(i, net):
        d = port_rep3.Rep3Driver(PBN254, net, device="cpu")
        return CoGroth16(d, tracer if i == 0 else None).prove(zk, shares[i])

    proofs = _named(run_parties, party)
    assert proofs[0] == proofs[1] == proofs[2]
    assert [r[1] for r in tracer.rows] == [SPAN_WITNESS_MAP, SPAN_MSM_HL, SPAN_ENDGAME]
    pvk = dict(vk, curve=PBN254)
    assert verify_groth16(pvk, proofs[0], publics)
    assert not verify_groth16(pvk, proofs[0], [publics[0] + 1, publics[1]])
    assert ref_verify(vk, {**proofs[0], "curve": BN254}, publics)

    # ---- the JAX package, same seeds ----
    rfr = ref_get_field(BN254.fr.p, "bn254.fr")
    rzk = ref_read_zkey(zkey_bytes)
    rshares = ref_split_rep3(RefWitness(BN254, len(vals), rfr.to_limbs(vals)), 2, seed=99)
    for s, rs in zip(shares, rshares):
        assert same(s.witness.a, rs.witness.a) and same(s.witness.b, rs.witness.b)

    def ref_party(i, net):
        return RefCoGroth16(ref_rep3.Rep3Driver(BN254, net)).prove(rzk, rshares[i])

    ref_proofs = _named(ref_run_parties, ref_party)
    for k in ("pi_a", "pi_b", "pi_c"):
        assert proofs[0][k] == ref_proofs[0][k]
    assert verify_groth16(pvk, {**ref_proofs[0], "curve": PBN254}, publics)
