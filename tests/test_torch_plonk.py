"""co-PLONK in the port against the JAX package, tolerance 0: the setup's
zkey bytes and vk, the zkey reader, the public prefix products and sums,
`prefix_mul` and `evaluate_poly_public`, and a Plain proof with
deterministic blinding whose JSON is byte-equal to the reference's and
which both verifiers accept (and refuse with a changed public input).

The fixture is a multiplier chain plus one constraint with a three-term
side (two additions, the second reading the first), 15 gates, domain 16.
The JAX proof is made live here and must equal its pinned entry
(tests/reference_pins.py): this file is the PLONK anchor of the pins.
"""

import random
import warnings

import numpy as np
import pytest
import reference_pins
import torch
from cocircom_tpu.fields.params import BLS12_381, BN254
from cocircom_tpu.io.plonk_zkey import read_plonk_zkey as ref_read
from cocircom_tpu.io.r1cs import R1CS as RefR1CS
from cocircom_tpu.mpc.driver import PlainDriver as RefPlainDriver
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.snark.plonk_setup import plonk_setup as ref_setup
from cocircom_tpu.snark.plonk_verify import verify_plonk as ref_verify
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.fields.params import curve_by_name
from cocircom_tpu_torch.io.jsonio import dump_plonk_proof, parse_plonk_proof
from cocircom_tpu_torch.io.plonk_zkey import read_plonk_zkey
from cocircom_tpu_torch.io.r1cs import R1CS
from cocircom_tpu_torch.mpc.driver import PlainDriver
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.snark.groth16 import SharedWitness
from cocircom_tpu_torch.snark.plonk import CoPlonk
from cocircom_tpu_torch.snark.plonk_setup import plonk_setup
from cocircom_tpu_torch.snark.plonk_verify import verify_plonk
from torch_port_util import plonk_chain, same, small_msm_engines

SEED = b"torch-port-plonk"


def _chain(ref_curve):
    """The fixture for both packages: (reference r1cs, port r1cs, values)."""
    r1cs, vals = plonk_chain(ref_curve, RefR1CS, 12, 5)
    port, _ = plonk_chain(curve_by_name(ref_curve.name), R1CS, 12, 5)
    return r1cs, port, vals


def _reference_inputs(zkey_bytes, vals):
    """What the JAX package's Plain prover is handed."""
    return {"kind": "plonk/plain", "curve": "bn254", "zkey": zkey_bytes, "public": vals[:3],
            "private": vals[3:], "deterministic_blinding": True, "msm_t": 2}


def reference_inputs():
    r1cs, _, vals = _chain(BN254)
    return [_reference_inputs(ref_setup(r1cs, seed=SEED)[0], vals)]


def test_plain_proof_equals_reference_and_verifies(monkeypatch):
    monkeypatch.setenv("COCIRCOM_INSECURE_DETERMINISTIC", "1")
    restore = small_msm_engines(monkeypatch)
    try:
        r1cs, pr1cs, vals = _chain(BN254)
        zkey_bytes, vk = plonk_setup(pr1cs, seed=SEED)
        ref_bytes, ref_vk = ref_setup(r1cs, seed=SEED)
        assert zkey_bytes == ref_bytes
        publics = [vals[1], vals[2]]

        d = PlainDriver(pr1cs.curve, device="cpu")
        zk = read_plonk_zkey(zkey_bytes, device="cpu")
        assert zk.n_additions == 2 and zk.domain_size == 16
        shared = SharedWitness(vals[:3], d.fr.encode(vals[3:]))
        # the reference's round 4 converts a 1-element array to int, which
        # NumPy deprecates (ROADMAP fault 3.f); the port must not
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            proof = CoPlonk(d, deterministic_blinding=True).prove(zk, shared)

        inputs = _reference_inputs(ref_bytes, vals)
        ref_json = reference_pins.prove(inputs)
        assert ref_json == reference_pins.pinned(inputs)
        assert dump_plonk_proof(pr1cs.curve, proof) == ref_json

        assert verify_plonk(vk, proof, publics)
        assert ref_verify(ref_vk, {**proof, "curve": BN254}, publics)
        assert not verify_plonk(vk, proof, [publics[0] + 1, publics[1]])
        assert not ref_verify(ref_vk, {**proof, "curve": BN254}, [publics[0], publics[1] + 1])
        again = parse_plonk_proof(dump_plonk_proof(pr1cs.curve, proof))
        assert verify_plonk(vk, again, publics)
    finally:
        restore()


@pytest.mark.parametrize("ref_curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
def test_setup_bytes_vk_and_reader_equal_reference(ref_curve):
    r1cs, pr1cs, _ = _chain(ref_curve)
    zkey_bytes, vk = plonk_setup(pr1cs, seed=SEED)
    ref_bytes, ref_vk = ref_setup(r1cs, seed=SEED)
    assert zkey_bytes == ref_bytes
    assert {k: v for k, v in vk.items() if k != "curve"} == \
        {k: v for k, v in ref_vk.items() if k != "curve"}
    assert vk["curve"].name == ref_vk["curve"].name

    zk = read_plonk_zkey(zkey_bytes, device="cpu")
    rzk = ref_read(ref_bytes)
    assert zk.curve.name == rzk.curve.name
    for k in ("n_vars", "n_public", "domain_size", "power", "n_additions", "n_constraints",
              "k1", "k2", "qm_c", "ql_c", "qr_c", "qo_c", "qc_c", "s1_c", "s2_c", "s3_c", "x_2"):
        assert getattr(zk, k) == getattr(rzk, k), k
    for k in ("add_id1", "add_id2", "map_a", "map_b", "map_c"):
        assert np.array_equal(getattr(zk, k), getattr(rzk, k)), k
    assert same(zk.add_f1, rzk.add_f1) and same(zk.add_f2, rzk.add_f2)
    for k in ("qm", "ql", "qr", "qo", "qc", "s1", "s2", "s3"):
        assert same(getattr(zk, k).coeffs, getattr(rzk, k).coeffs), k
        assert same(getattr(zk, k).evals, getattr(rzk, k).evals), k
    assert len(zk.lagrange) == len(rzk.lagrange) == 2
    for p, rp in zip(zk.lagrange, rzk.lagrange):
        assert same(p.coeffs, rp.coeffs) and same(p.evals, rp.evals)
    assert same(zk.p_tau.x, rzk.p_tau.x) and same(zk.p_tau.y, rzk.p_tau.y)


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_cumprod_prefix_sums_prefix_mul_and_evaluation_equal_reference(n):
    fr = get_field(BN254.fr.p, "bn254.fr", "cpu")
    rfr = ref_get_field(BN254.fr.p, "bn254.fr")
    rng = random.Random(1000 + n)
    vals = [rng.randrange(1, fr.p) for _ in range(n)]
    x, rx = fr.encode(vals), rfr.encode(vals)
    assert same(fr.cumprod(x), rfr.cumprod(rx))
    assert same(fr.prefix_sums(x), rfr.prefix_sums(rx))
    # the same pieces through a (3, n) batch along axis 2
    x3 = torch.stack([x, x, x], dim=1)
    assert torch.equal(fr.cumprod(x3, axis=2)[:, 1], fr.cumprod(x))
    assert torch.equal(fr.prefix_sums(x3, axis=2)[:, 2], fr.prefix_sums(x))

    # prefix_mul draws its masks from each package's own Plain stream, but
    # what it returns is the prefix products themselves
    d, rd = PlainDriver(PBN254, device="cpu"), RefPlainDriver(BN254)
    got = d.prefix_mul(x)
    assert same(got, rd.prefix_mul(rx))
    want, acc = [], 1
    for v in vals:
        acc = acc * v % fr.p
        want.append(acc)
    assert list(fr.decode(got)) == want
    xi = rng.randrange(fr.p)
    ev = d.evaluate_poly_public(x, xi)
    assert same(ev, rd.evaluate_poly_public(rx, xi))
    assert int(fr.decode(ev)) == sum(c * pow(xi, i, fr.p) for i, c in enumerate(vals)) % fr.p


def test_deterministic_blinding_needs_acknowledgement(monkeypatch):
    monkeypatch.delenv("COCIRCOM_INSECURE_DETERMINISTIC", raising=False)
    with pytest.raises(PermissionError, match="zero-knowledge"):
        CoPlonk(PlainDriver(PBN254, device="cpu"), deterministic_blinding=True)
