"""Port vs JAX package and host: MSM, G1 (mixed-add path) and G2
(complete-add path); results compared by affine decode.

Sizes are tiny and the rank split is T = 2 so the plain versions stay fast
on the CPU.  The JAX side runs its madd path with the Pallas kernel in
interpret mode (COCIRCOM_FORCE_MADD=interpret).
"""

import random

import jax
import jax.numpy as jnp
import pytest
import torch

from cocircom_tpu.fields.ec_host import ec_add, ec_mul
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.ops.curve import g1_ops as ref_g1_ops
from cocircom_tpu.ops.curve import g2_ops as ref_g2_ops
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.ops.msm import MSM as RefMSM
from cocircom_tpu.pairing.tower import Tower
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.ops.curve import g1_ops, g2_ops, pmap
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.ops.msm import MSM, _signed_digits, _top_window_packing

R = BN254.fr.p
TW = Tower(BN254)
G1H = (TW.fp(1), TW.fp(2))
(_x0, _x1), (_y0, _y1) = BN254.g2_gen
G2H = (TW.fp2(_x0, _x1), TW.fp2(_y0, _y1))


def h1(k):
    p = ec_mul(G1H, k % R)
    return None if p is None else (p[0].v, p[1].v)


def h2(k):
    p = ec_mul(G2H, k % R)
    return None if p is None else ((p[0].c0.v, p[0].c1.v), (p[1].c0.v, p[1].c1.v))


def _case(n, seed, zero_at=None, all_zero=False):
    rng = random.Random(seed)
    ks = [rng.randrange(1, 60) for _ in range(n)]
    sc = [0] * n if all_zero else [rng.randrange(R) for _ in range(n)]
    if zero_at is not None:
        sc[zero_at] = 0
    return ks, sc, sum(k * s for k, s in zip(ks, sc)) % R


@pytest.fixture(scope="module")
def engines():
    """One engine per group for the whole module: its salted bucket init
    and correction point are computed once."""
    fr = get_field(R, "bn254.fr", device="cpu")
    e1 = MSM(g1_ops(PBN254, "cpu"), c=6, t=2, scalar_bits=254)
    e2 = MSM(g2_ops(PBN254, "cpu"), c=6, t=2, scalar_bits=254)
    return fr, e1, e2


def test_signed_digits_recompose():
    fr = get_field(R, "bn254.fr", device="cpu")
    sc = [0, 1, R - 1, (1 << 253) + 12345, 0x8000_0000_FFFF_FFFF]
    for c in (4, 6, 12):
        digits = _signed_digits(fr.to_limbs(sc), 254, c)
        nw, _, _ = _top_window_packing(254, c)
        assert len(digits) == nw
        for j, s in enumerate(sc):
            assert sum(int(d[j]) << (c * w) for w, d in enumerate(digits)) == s
            assert all(abs(int(d[j])) <= 1 << (c - 1) for d in digits)


def test_signed_digits_match_reference():
    from cocircom_tpu.ops.msm import _signed_digits as ref_digits

    rfr = ref_get_field(R, "bn254.fr")
    fr = get_field(R, "bn254.fr", device="cpu")
    sc = [0, 5, R - 1] + [random.Random(1).randrange(R) for _ in range(9)]
    for c in (5, 12):
        ref = ref_digits(jnp.asarray(rfr.to_limbs(sc)), 254, c)
        got = _signed_digits(fr.to_limbs(sc), 254, c)
        for r, g in zip(ref, got):
            assert [int(v) for v in r] == [int(v) for v in g]


def test_g1_n7_c6_zero_scalar_matches_reference_and_host(engines, monkeypatch):
    """n = 7, c = 6, one zero scalar: the zero digit positions are dead
    slots of the permuted table, which must be dropped and never land in
    another window's slot 0."""
    fr, e1, _ = engines
    ks, sc, total = _case(7, 11, zero_at=2)
    got = e1.msm(e1.ops.encode_points([h1(k) for k in ks]), fr.to_limbs(sc))
    got = e1.ops.decode_points(pmap(lambda c: c[:, None], got))[0]
    assert got == h1(total)
    # the JAX package's madd path, Pallas kernel in interpret mode
    monkeypatch.setenv("COCIRCOM_FORCE_MADD", "interpret")
    rops = ref_g1_ops(BN254)
    rfr = ref_get_field(R, "bn254.fr")
    reng = RefMSM(rops, 6, 2, 254)
    ref = reng.msm(rops.encode_points([h1(k) for k in ks]), jnp.asarray(rfr.to_limbs(sc)))
    ref = rops.decode_points(jax.tree.map(lambda c: c[..., None], ref))[0]
    assert got == ref


@pytest.mark.parametrize("n,chunk_log,kw", [
    (13, 17, {}),                    # n not a multiple of T, with a run > T
    (5, 17, {"all_zero": True}),     # all-zero scalars: no wave runs
    (11, 2, {"zero_at": 0}),         # chunked: three chunks into one accumulator
])
def test_g1_shapes_match_host(engines, n, chunk_log, kw):
    fr, e1, _ = engines
    ks, sc, total = _case(n, 20 + n, **kw)
    if n == 13:
        sc[3] = sc[4] = sc[5] = sc[1]      # equal scalars share every bucket
        total = sum(k * s for k, s in zip(ks, sc)) % R
    e1.CHUNK_LOG = chunk_log
    try:
        res = e1.msm(e1.ops.encode_points([h1(k) for k in ks]), fr.to_limbs(sc))
    finally:
        del e1.CHUNK_LOG
    assert e1.ops.decode_points(pmap(lambda c: c[:, None], res))[0] == h1(total)


def test_g1_identity_base_and_two_components(engines):
    fr, e1, _ = engines
    ks, sa, ta = _case(7, 31)
    _, sb, _ = _case(7, 32, zero_at=4)
    pts = [None if i == 3 else h1(k) for i, k in enumerate(ks)]
    ta = sum(k * s for i, (k, s) in enumerate(zip(ks, sa)) if i != 3) % R
    tb = sum(k * s for i, (k, s) in enumerate(zip(ks, sb)) if i != 3) % R
    res = e1.msm_many(e1.ops.encode_points(pts), [fr.to_limbs(sa), fr.to_limbs(sb)])
    assert e1.ops.decode_points(res) == [h1(ta), h1(tb)]


def test_g2_n7_c6_zero_scalar_and_chunked_match_host(engines):
    fr, _, e2 = engines
    ks, sc, total = _case(7, 41, zero_at=5)
    pts = e2.ops.encode_points([h2(k) for k in ks])
    res = e2.msm(pts, fr.to_limbs(sc))
    assert e2.ops.decode_points(pmap(lambda c: c[:, None], res))[0] == h2(total)
    e2.CHUNK_LOG = 2
    try:
        res = e2.msm(pts, fr.to_limbs(sc))
    finally:
        del e2.CHUNK_LOG
    assert e2.ops.decode_points(pmap(lambda c: c[:, None], res))[0] == h2(total)
    host = None
    for k, s in zip(ks, sc):
        host = ec_add(host, ec_mul(ec_mul(G2H, k), s))
    assert h2(total) == ((host[0].c0.v, host[0].c1.v), (host[1].c0.v, host[1].c1.v))


def test_g2_n7_c6_zero_scalar_matches_reference(engines):
    """The complete-add path against the JAX package's MSM on the same
    points and scalars (n = 7, c = 6, one zero scalar)."""
    fr, _, e2 = engines
    ks, sc, total = _case(7, 43, zero_at=1)
    got = e2.msm(e2.ops.encode_points([h2(k) for k in ks]), fr.to_limbs(sc))
    got = e2.ops.decode_points(pmap(lambda c: c[:, None], got))[0]
    rops = ref_g2_ops(BN254)
    rfr = ref_get_field(R, "bn254.fr")
    reng = RefMSM(rops, 6, 2, 254)
    ref = reng.msm(rops.encode_points([h2(k) for k in ks]), jnp.asarray(rfr.to_limbs(sc)))
    ref = rops.decode_points(jax.tree.map(lambda c: c[..., None], ref))[0]
    assert got == ref == h2(total)


def test_empty_msm_is_identity(engines):
    fr, e1, _ = engines
    pts = e1.ops.encode_points([h1(3)])
    res = e1.msm(pmap(lambda c: c[:, :0], pts), torch.zeros((8, 0), dtype=torch.int32))
    assert e1.ops.decode_points(pmap(lambda c: c[:, None], res)) == [None]
