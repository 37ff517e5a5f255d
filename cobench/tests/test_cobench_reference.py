"""The plain reference against answers known at a tiny size."""

import random

import numpy as np
import pytest

from cobench.reference import groth16 as g
from cobench.reference.fr_torch import Field

P = g.P


def naive_eval(coeffs, x):
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc * x + int(c)) % P
    return acc


def test_roots_are_snarkjs():
    q, roots = g.snarkjs_roots()
    assert q == 5 and len(roots) == 29
    assert pow(roots[28], 1 << 27, P) == P - 1 and pow(roots[3], 8, P) == 1
    assert g.coset_root(4) == roots[5]


@pytest.mark.parametrize("logn", [1, 3, 5])
def test_ntt_is_the_dft(logn):
    n = 1 << logn
    rng = random.Random(logn)
    x = np.array([rng.randrange(P) for _ in range(n)], dtype=object)
    w = g.snarkjs_roots()[1][logn]
    want = [sum(int(x[i]) * pow(w, i * j, P) for i in range(n)) % P for j in range(n)]
    assert list(g.ntt(x, w)) == want


def test_to_coset_evaluates_the_interpolant_on_the_coset():
    logn, n = 3, 8
    rng = random.Random(7)
    coeffs = [rng.randrange(P) for _ in range(n)]
    w = g.snarkjs_roots()[1][logn]
    on_domain = np.array([naive_eval(coeffs, pow(w, j, P)) for j in range(n)], dtype=object)
    gc = g.coset_root(logn)
    want = [naive_eval(coeffs, gc * pow(w, j, P) % P) for j in range(n)]
    assert list(g.to_coset(on_domain, logn)) == want


def test_limbs_to_ints():
    import torch

    limbs = np.array([[1, 0xFFFFFFFF], [2, 0]], dtype=np.uint32)
    f = Field(P, "cpu")
    raw = torch.from_numpy(limbs.astype(np.int64)).to(torch.int32)
    assert f.ints(f.from_u32(raw)) == [1 + (2 << 32), 0xFFFFFFFF]


def test_field_operations_are_exact():
    rng = random.Random(3)
    xs = [rng.randrange(P) for _ in range(100)] + [0, 1, P - 1, P - 2]
    ys = [rng.randrange(P) for _ in range(100)] + [P - 1, 0, P - 1, 1]
    f = Field(P, "cpu")
    x, y = f.limbs(xs), f.limbs(ys)
    rinv = pow(f.R, P - 2, P)
    assert f.ints(f.mul(x, y)) == [a * b * rinv % P for a, b in zip(xs, ys)]
    assert f.ints(f.add(x, y)) == [(a + b) % P for a, b in zip(xs, ys)]
    assert f.ints(f.sub(x, y)) == [(a - b) % P for a, b in zip(xs, ys)]
    assert f.ints(f.from_mont(f.to_mont(x))) == xs


@pytest.mark.parametrize("logn", [1, 4, 6])
def test_the_device_ntt_is_the_host_ntt(logn):
    n = 1 << logn
    rng = random.Random(logn)
    v = [rng.randrange(P) for _ in range(n)]
    w = g.snarkjs_roots()[1][logn]
    f = Field(P, "cpu")
    out = f.from_mont(f.ntt(f.to_mont(f.limbs(v)), f.powers(w, n // 2)))
    assert f.ints(out) == list(g.ntt(np.array(v, dtype=object), w))


@pytest.mark.parametrize("logn", [3, 6])
def test_the_device_witness_map_and_scalars_are_the_hosts(logn):
    z, mult, hv = tiny_case(logn)
    n = 1 << logn
    wm = g.DeviceWitnessMap(logn, "cpu")
    zl = wm.f.limbs(list(z))
    h = wm(zl, 1, n - 3)
    assert wm.f.ints(h) == list(hv)
    assert wm.scalars(zl, h, mult) == g.scalars(z, mult, hv)


def tiny_case(logn=3, seed=5):
    rng = random.Random(seed)
    n = 1 << logn
    z = np.array([1, rng.randrange(P)] + [rng.randrange(1 << 253) for _ in range(n - 2)],
                 dtype=object)
    mult = {k: np.array([rng.randrange(1 << 15) | 1 for _ in range(m)], dtype=np.int64)
            for k, m in (("a", n), ("b1", n), ("l", n - 2), ("h", n), ("b2", n))}
    hv = g.witness_map(z, 1, n - 3, logn)
    return z, mult, hv


def test_witness_map_is_ab_minus_c_on_the_coset():
    logn, n = 3, 8
    z, _, hv = tiny_case(logn)
    nc = n - 3
    a = [int(z[(7 * j + 1) % n]) for j in range(nc)] + [1, int(z[1])] + [0]
    b = [int(z[(13 * j + 3) % n]) for j in range(nc)] + [0] * 3
    c = [x * y % P for x, y in zip(a, b)]
    w = g.snarkjs_roots()[1][logn]
    winv, ninv = pow(w, P - 2, P), pow(n, P - 2, P)

    def at(vals, x):   # the interpolant of vals on the domain, at x
        coeffs = [sum(v * pow(winv, i * j, P) for j, v in enumerate(vals)) * ninv % P
                  for i in range(n)]
        return naive_eval(coeffs, x)

    gc = g.coset_root(logn)
    for j in range(n):
        x = gc * pow(w, j, P) % P
        assert hv[j] == (at(a, x) * at(b, x) - at(c, x)) % P


def prove_in_exponent(s: dict, r: int, s_: int, cv) -> dict:
    """The honest proof for blinding r, s from the discrete logs (the
    reference module's docstring)."""
    a = (s["a0"] + r * g.DELTA) % P
    c = (s_ * a + r * s["b0"] + s["lh"]) % P
    return {"pi_a": g._ints1(g.ec_mul(cv.g1, a)),
            "pi_b": g._ints2(g.ec_mul(cv.g2, (s["b0g2"] + s_ * g.DELTA) % P)),
            "pi_c": g._ints1(g.ec_mul(cv.g1, c))}


def test_an_honest_proof_passes_and_a_changed_one_fails():
    z, mult, hv = tiny_case()
    s = g.scalars(z, mult, hv)
    cv = g.Curves()
    proof = prove_in_exponent(s, 123456789, 987654321, cv)
    assert g.check_proof(proof, s, cv)
    other = prove_in_exponent(dict(s, lh=(s["lh"] + 1) % P), 123456789, 987654321, cv)
    assert not g.check_proof(dict(proof, pi_c=other["pi_c"]), s, cv)
    assert not g.check_proof(dict(proof, pi_c=None), s, cv)
    bad = dict(proof, pi_c=other["pi_c"])
    assert g.check_proofs([(proof, s), (bad, s), (proof, s)], workers=2) == [True, False, True]


def test_pairing_is_bilinear():
    cv = g.Curves()
    a, b = 1234567, 7654321
    e = cv.pairing
    lhs = e.pairing(g._ints1(g.ec_mul(cv.g1, a)), g._ints2(g.ec_mul(cv.g2, b)))
    rhs = e.pairing(g._ints1(g.ec_mul(cv.g1, a * b)), g._ints2(cv.g2))
    assert lhs == rhs and lhs != cv.t.fp12_one()
