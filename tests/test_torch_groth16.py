"""The slice as a whole, single party: zkey loading and a Plain Groth16
proof in the port against the JAX package, tolerance 0.

A hand-built R1CS goes through the JAX package's `groth16_setup`; both
packages load the zkey bytes; `zkey_from_reference` must agree with the
port's own loader; with `rand` pinned the two Plain proofs are equal and
verify under both packages' verifiers.
"""

import numpy as np
import pytest
import torch

import cocircom_tpu.mpc.driver as ref_driver
import cocircom_tpu_torch.mpc.driver as port_driver
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.io.r1cs import R1CS as RefR1CS
from cocircom_tpu.io.witness import Witness as RefWitness
from cocircom_tpu.io.zkey import read_groth16_zkey as ref_read_zkey
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.snark.groth16 import CoGroth16 as RefCoGroth16
from cocircom_tpu.snark.groth16_verify import verify_groth16 as ref_verify
from cocircom_tpu.snark.setup import groth16_setup as ref_setup
from cocircom_tpu.snark.shared import split_witness_plain as ref_split_plain
from cocircom_tpu_torch import convert
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.io.r1cs import R1CS
from cocircom_tpu_torch.io.witness import Witness, read_wtns, write_wtns
from cocircom_tpu_torch.io.zkey import read_groth16_zkey
from cocircom_tpu_torch.ops.field import ints_to_limbs_np
from cocircom_tpu_torch.snark.groth16 import CoGroth16
from cocircom_tpu_torch.snark.groth16_verify import verify_groth16
from cocircom_tpu_torch.snark.setup import groth16_setup
from cocircom_tpu_torch.snark.shared import split_witness_plain
from torch_port_util import multiplier_chain, same, small_msm_engines

N_MUL = 20


@pytest.fixture(scope="module")
def circuit():
    r1cs, vals = multiplier_chain(BN254, RefR1CS, N_MUL, 3)
    zkey_bytes, vk = ref_setup(r1cs, seed=b"torch-port")
    return r1cs, vals, zkey_bytes, vk


@pytest.fixture()
def small_engines(monkeypatch):
    restore = small_msm_engines(monkeypatch)
    yield
    restore()


def _pin_rand(monkeypatch):
    """Both Plain drivers draw r = 5, s = 7 (their own generators differ)."""
    vals = {"ref": iter([5, 7]), "port": iter([5, 7])}
    monkeypatch.setattr(ref_driver.PlainDriver, "rand",
                        lambda self, shape=(): self.fr.encode([next(vals["ref"])])[:, 0])
    monkeypatch.setattr(port_driver.PlainDriver, "rand",
                        lambda self, shape=(): self.fr.encode([next(vals["port"])])[:, 0])


def test_setup_bytes_equal_and_zkey_loaders_agree(circuit):
    r1cs, vals, zkey_bytes, vk = circuit
    pr1cs, pvals = multiplier_chain(PBN254, R1CS, N_MUL, 3)
    assert pvals == vals
    pbytes, pvk = groth16_setup(pr1cs, seed=b"torch-port")
    assert pbytes == zkey_bytes
    assert {k: v for k, v in pvk.items() if k != "curve"} == \
        {k: v for k, v in vk.items() if k != "curve"}

    ref = ref_read_zkey(zkey_bytes)
    zk = read_groth16_zkey(zkey_bytes, device="cpu")
    conv = convert.zkey_from_reference(ref, device="cpu")
    for name in ("n_vars", "n_public", "domain_size", "pow", "alpha_g1", "beta_g1",
                 "beta_g2", "gamma_g2", "delta_g1", "delta_g2"):
        assert getattr(zk, name) == getattr(ref, name) == getattr(conv, name)
    for q in ("ic", "a_query", "b_g1_query", "l_query", "h_query"):
        for c in ("x", "y"):
            assert same(getattr(getattr(zk, q), c), getattr(getattr(ref, q), c))
            assert torch.equal(getattr(getattr(zk, q), c), getattr(getattr(conv, q), c))
    for c in ("x0", "x1", "y0", "y1"):
        assert same(getattr(zk.b_g2_query, c), getattr(ref.b_g2_query, c))
        assert torch.equal(getattr(zk.b_g2_query, c), getattr(conv.b_g2_query, c))
    m, rm, cm = zk.matrices, ref.matrices, conv.matrices
    assert m.num_constraints == rm.num_constraints == N_MUL
    for name in ("a_rows", "a_cols", "b_rows", "b_cols"):
        assert np.array_equal(getattr(m, name).numpy(), getattr(rm, name).astype(np.int64))
        assert torch.equal(getattr(m, name), getattr(cm, name))
    assert same(m.a_coeffs, rm.a_coeffs) and same(m.b_coeffs, rm.b_coeffs)
    assert torch.equal(m.a_coeffs, cm.a_coeffs)


def test_witness_file_round_trip(circuit):
    _, vals, _, _ = circuit
    std = ints_to_limbs_np(vals, 8)
    w = read_wtns(write_wtns(PBN254, std))
    assert w.values_ints() == vals and w.n_witness == len(vals)
    from cocircom_tpu.io.witness import read_wtns as ref_read_wtns

    rw = ref_read_wtns(write_wtns(PBN254, std))
    assert rw.values_ints() == vals


def test_plain_proof_equals_reference_and_verifies(circuit, small_engines, monkeypatch):
    _, vals, zkey_bytes, vk = circuit
    _pin_rand(monkeypatch)
    publics = [vals[1], vals[2]]

    rfr = ref_get_field(BN254.fr.p, "bn254.fr")
    rwit = RefWitness(BN254, len(vals), rfr.to_limbs(vals))
    ref_proof = RefCoGroth16(ref_driver.PlainDriver(BN254)).prove(
        ref_read_zkey(zkey_bytes), ref_split_plain(rwit, 2))

    wit = Witness(PBN254, len(vals), ints_to_limbs_np(vals, 8))
    zk = read_groth16_zkey(zkey_bytes, device="cpu")
    proof = CoGroth16(port_driver.PlainDriver(PBN254, device="cpu")).prove(
        zk, split_witness_plain(wit, 2, device="cpu"))

    for k in ("pi_a", "pi_b", "pi_c"):
        assert proof[k] == ref_proof[k]
    pvk = dict(vk, curve=PBN254)
    assert ref_verify(vk, {**proof, "curve": BN254}, publics)
    assert verify_groth16(pvk, proof, publics)
    assert verify_groth16(pvk, {**ref_proof, "curve": PBN254}, publics)
    assert not verify_groth16(pvk, proof, [publics[0], publics[1] + 1])
