"""The slice as a whole: a 3-party REP3 co-Groth16 proof in the port
against the JAX package, every seed pinned, tolerance 0.

Both packages split the same witness with the same dealer seed, the three
parties exchange pinned PRF seeds, and the proofs must be equal point for
point and verify under both packages' pairing verifiers.  The JAX
package's proof is its pinned one (tests/reference_pins.py).
"""

import functools

import cocircom_tpu_torch.mpc.rep3 as port_rep3
import reference_pins
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.io.r1cs import R1CS as RefR1CS
from cocircom_tpu.io.witness import Witness as RefWitness
from cocircom_tpu.ops.field import get_field as ref_get_field
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
from torch_port_util import multiplier_chain, pin_rep3_seeds, run_named, same, small_msm_engines

SEEDS = [bytes([0x10 + i]) * 32 for i in range(3)]


@functools.lru_cache(maxsize=None)
def _circuit():
    r1cs, vals = multiplier_chain(BN254, RefR1CS, 12, 5)
    zkey_bytes, vk = ref_setup(r1cs, seed=b"torch-port-rep3")
    return vals, zkey_bytes, vk


def reference_inputs():
    """What the JAX package's REP3 prover is handed."""
    vals, zkey_bytes, _ = _circuit()
    return [{"kind": "groth16/rep3", "curve": "bn254", "zkey": zkey_bytes, "witness": vals,
             "n_public": 2, "split_seed": 99, "prf_seeds": SEEDS, "msm_t": 2}]


def test_rep3_proof_equals_reference_and_verifies(monkeypatch):
    restore = small_msm_engines(monkeypatch)
    try:
        _run(monkeypatch)
    finally:
        restore()


def _run(monkeypatch):
    pin_rep3_seeds(monkeypatch, port_rep3, seeds=SEEDS)
    vals, zkey_bytes, vk = _circuit()
    publics = [vals[1], vals[2]]

    # ---- the port ----
    zk = read_groth16_zkey(zkey_bytes, device="cpu")
    wit = Witness(PBN254, len(vals), ints_to_limbs_np(vals, 8))
    shares = split_witness_rep3(wit, 2, seed=99, device="cpu")
    tracers = [None] * 3

    def party(i, net):
        # party 0's phase rows; every party's intervals, on the tracer its
        # own thread made
        tracers[i] = Tracer(enabled=i == 0, intervals=True)
        d = port_rep3.Rep3Driver(PBN254, net, device="cpu")
        return CoGroth16(d, tracers[i] if i == 0 else None).prove(zk, shares[i])

    proofs = run_named(run_parties, party)
    assert proofs[0] == proofs[1] == proofs[2]
    assert [r[1] for r in tracers[0].rows] == [SPAN_WITNESS_MAP, SPAN_MSM_HL, SPAN_ENDGAME]
    assert all(t.rows == [] for t in tracers[1:])
    for t in tracers:
        names = {n for n, *_ in t.intervals}
        assert {"msm.affine", "msm.waves", "ntt.forward", "ntt.inverse", "ntt.coset",
                "mpc.prf_setup", "mpc.mul", "mpc.open", "g16.constraints",
                "g16.prove"} <= names, names
    pvk = dict(vk, curve=PBN254)
    assert verify_groth16(pvk, proofs[0], publics)
    assert not verify_groth16(pvk, proofs[0], [publics[0] + 1, publics[1]])
    assert ref_verify(vk, {**proofs[0], "curve": BN254}, publics)

    # ---- the JAX package, same seeds ----
    rfr = ref_get_field(BN254.fr.p, "bn254.fr")
    rshares = ref_split_rep3(RefWitness(BN254, len(vals), rfr.to_limbs(vals)), 2, seed=99)
    for s, rs in zip(shares, rshares):
        assert same(s.witness.a, rs.witness.a) and same(s.witness.b, rs.witness.b)

    ref_proof = reference_pins.groth16_proof(reference_pins.pinned(reference_inputs()[0]))
    for k in ("pi_a", "pi_b", "pi_c"):
        assert proofs[0][k] == ref_proof[k]
    assert verify_groth16(pvk, {**ref_proof, "curve": PBN254}, publics)
