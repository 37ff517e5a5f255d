"""The port over BLS12-381 as a whole, single party: the zkey loader follows
the curve named by the file's primes, `zkey_from_reference` carries a
24-limb zkey across, and a Plain Groth16 proof verifies under both packages'
pairing verifiers and, with `rand` pinned, equals the JAX package's pinned
proof (tests/reference_pins.py) point for point.  Tolerance 0.
"""

import functools

import reference_pins
import torch

import cocircom_tpu_torch.mpc.driver as port_driver
from cocircom_tpu.fields.params import BLS12_381
from cocircom_tpu.io.r1cs import R1CS as RefR1CS
from cocircom_tpu.io.zkey import read_groth16_zkey as ref_read_zkey
from cocircom_tpu.snark.groth16_verify import verify_groth16 as ref_verify
from cocircom_tpu.snark.setup import groth16_setup as ref_setup
from cocircom_tpu_torch import convert
from cocircom_tpu_torch.fields.params import BLS12_381 as PBLS
from cocircom_tpu_torch.io.r1cs import multiplier_chain as port_multiplier_chain
from cocircom_tpu_torch.io.witness import Witness
from cocircom_tpu_torch.io.zkey import read_groth16_zkey
from cocircom_tpu_torch.ops.field import ints_to_limbs_np
from cocircom_tpu_torch.snark.groth16 import CoGroth16
from cocircom_tpu_torch.snark.groth16_verify import verify_groth16
from cocircom_tpu_torch.snark.setup import groth16_setup
from cocircom_tpu_torch.snark.shared import split_witness_plain
from torch_port_util import multiplier_chain, same, small_msm_engines

N_MUL = 5


@functools.lru_cache(maxsize=None)
def _circuit():
    r1cs, vals = multiplier_chain(BLS12_381, RefR1CS, N_MUL, 3)
    zkey_bytes, vk = ref_setup(r1cs, seed=b"torch-port-bls")
    return vals, zkey_bytes, vk


def reference_inputs():
    """What the JAX package's Plain prover is handed: `rand` draws r = 5, s = 7."""
    vals, zkey_bytes, _ = _circuit()
    return [{"kind": "groth16/plain", "curve": "bls12_381", "zkey": zkey_bytes,
             "witness": vals, "n_public": 2, "rand": [5, 7], "msm_t": 2}]


def test_plain_groth16_proof_equals_reference_and_verifies(monkeypatch):
    restore = small_msm_engines(monkeypatch)
    try:
        _prove(monkeypatch)
    finally:
        restore()


def _prove(monkeypatch):
    rand = iter([5, 7])
    monkeypatch.setattr(port_driver.PlainDriver, "rand",
                        lambda self, shape=(): self.fr.encode([next(rand)])[:, 0])
    vals, zkey_bytes, vk = _circuit()
    port_r1cs, pvals = port_multiplier_chain(PBLS, N_MUL, 3)
    pbytes, pvk = groth16_setup(port_r1cs, seed=b"torch-port-bls")
    assert pvals == vals and pbytes == zkey_bytes
    publics = [vals[1], vals[2]]

    ref_zk = ref_read_zkey(zkey_bytes)
    zk = read_groth16_zkey(zkey_bytes, device="cpu")
    assert zk.curve is PBLS and zk.a_query.x.shape[0] == 12
    conv = convert.zkey_from_reference(ref_zk, device="cpu")
    assert conv.curve is PBLS
    for q in ("ic", "a_query", "b_g1_query", "l_query", "h_query"):
        for c in ("x", "y"):
            assert same(getattr(getattr(zk, q), c), getattr(getattr(ref_zk, q), c))
            assert torch.equal(getattr(getattr(zk, q), c), getattr(getattr(conv, q), c))
    for c in ("x0", "x1", "y0", "y1"):
        assert torch.equal(getattr(zk.b_g2_query, c), getattr(conv.b_g2_query, c))
    assert same(zk.matrices.a_coeffs, ref_zk.matrices.a_coeffs)

    ref_proof = reference_pins.groth16_proof(reference_pins.pinned(reference_inputs()[0]))

    wit = Witness(PBLS, len(vals), ints_to_limbs_np(vals, 8))
    proof = CoGroth16(port_driver.PlainDriver(PBLS, device="cpu")).prove(
        zk, split_witness_plain(wit, 2, device="cpu"))
    for k in ("pi_a", "pi_b", "pi_c"):
        assert proof[k] == ref_proof[k]
    assert verify_groth16(pvk, proof, publics)
    assert not verify_groth16(pvk, proof, [publics[0], publics[1] + 1])
    assert ref_verify(vk, {**proof, "curve": BLS12_381}, publics)


def test_zkey_loader_follows_the_files_primes():
    """The curve comes from the header's two primes; other primes are refused."""
    import pytest

    r1cs, _ = port_multiplier_chain(PBLS, 2, 3)
    data, _ = groth16_setup(r1cs, seed=b"torch-port-bls-small")
    zk = read_groth16_zkey(data, device="cpu")
    assert zk.curve is PBLS and zk.ic.x.shape == (12, 3) and zk.matrices.a_coeffs.shape[0] == 8
    q = PBLS.fq.p.to_bytes(48, "little")
    at = data.index(q)
    bad = data[:at] + (PBLS.fq.p + 2).to_bytes(48, "little") + data[at + 48:]
    with pytest.raises(ValueError, match="unknown curve"):
        read_groth16_zkey(bad, device="cpu")


def test_witness_file_round_trip_over_bls_fr():
    from cocircom_tpu_torch.io.witness import read_wtns, write_wtns

    _, vals = port_multiplier_chain(PBLS, 4, 7)
    w = read_wtns(write_wtns(PBLS, ints_to_limbs_np(vals, 8)))
    assert w.curve is PBLS and w.values_ints() == vals
