"""Port vs JAX package and host: the masked complete add of the MSM wave
(`ec_wave_add`) and the complete-add MSM that runs it (`MSM._msm_fused`).

The JAX side runs `ec_wave_add_pallas` in interpret mode, as its own tests
do on the CPU; the port runs `ec_wave_add_plain`, the row-level part of the
CUDA kernel's plain version, and the whole wave through the kernel's wrapper
`ec_wave_add`, which takes its plain version `add_wave_plain` because the
tensors lie on the CPU, against the JAX package's `MSM._wave_step` from the
same points, scalars and accumulator, each package running its own prepare.
Inputs are made from a seed with numpy; points are compared by affine
decode, untouched lanes bit for bit.  Tolerance 0.  The 12-limb row-level
case is in test_torch_bls12_381.py.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cocircom_tpu.ops.pallas_curve as ref_pallas_curve
from cocircom_tpu.fields.ec_host import ec_mul
from cocircom_tpu.fields.params import BLS12_381, BN254
from cocircom_tpu.ops.curve import ProjPoint as RefProjPoint
from cocircom_tpu.ops.curve import g1_ops as ref_g1_ops
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.ops.msm import MSM as RefMSM
from cocircom_tpu.ops.pallas_curve import ec_wave_add_pallas
from cocircom_tpu.pairing.tower import Tower
from cocircom_tpu_torch.fields.params import curve_by_name
from cocircom_tpu_torch.ops.curve import (ProjPoint, add_wave_lanes, ec_wave_add,
                                          ec_wave_add_plain, g1_ops, pmap)
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.ops.msm import MSM
from torch_port_util import same, to_port

WAVE_N, WAVE_C, WAVE_T, WAVE_BITS = 40, 4, 2, 16


def _host_points(curve, ks):
    """k*G as affine int pairs; k = 0 gives the identity (None)."""
    t = Tower(curve)
    g = (t.fp(curve.g1_gen[0]), t.fp(curve.g1_gen[1]))
    out = []
    for k in ks:
        p = ec_mul(g, int(k) % curve.fr.p) if k else None
        out.append(None if p is None else (p[0].v, p[1].v))
    return out


def _wave_case(curve, n, seed):
    """Lanes of every kind.  Returns (acc multipliers, point multipliers,
    neg, valid, index of a lane whose row is all zero)."""
    rng = np.random.default_rng(seed)
    ka = rng.integers(1, 1 << 14, size=n)
    kp = rng.integers(1, 1 << 14, size=n)
    neg = rng.integers(0, 2, n).astype(bool)
    valid = rng.integers(0, 2, n).astype(bool)
    ka[0] = 0                                     # identity accumulator, live
    valid[0], neg[0] = True, False
    kp[1] = 0                                     # identity point, live
    valid[1] = True
    kp[2] = ka[2]                                 # doubling
    valid[2], neg[2] = True, False
    kp[3] = ka[3]                                 # inverse point: acc + (-acc)
    valid[3], neg[3] = True, True
    kp[4] = 0                                     # identity point, negated
    valid[4], neg[4] = True, True
    valid[5], neg[5] = False, True                # masked lane with a zero row
    valid[6], neg[6] = True, True                 # plain negated add
    return ka, kp, neg, valid, 5


def _neg(curve, p):
    return None if p is None else (p[0], (-p[1]) % curve.fq.p)


def _compare(L, got, ref, acc_in, valid):
    """Every lane equal after the repack; masked lanes left as they were."""
    for g, r, a in zip(got, ref, acc_in):
        assert same(g, np.asarray(r))
        assert torch.equal(g.reshape(L, -1)[:, ~valid], a.reshape(L, -1)[:, ~valid])


def _wave_inputs(curve, seed):
    """40 points (host), 16-bit scalars and a pool of accumulator points for
    one wave of a small MSM: c = 4, T = 2, 5 windows (the top one packed) x 9
    bucket lanes x 2 ranks = 90 lanes."""
    rng = np.random.default_rng(seed)
    pts = _host_points(curve, rng.integers(1, 1 << 14, size=WAVE_N))
    sc = [int(v) for v in rng.integers(0, 1 << WAVE_BITS, size=WAVE_N)]
    sc[5] = 0
    pool = _host_points(curve, rng.integers(1, 1 << 14, size=23))
    return pts, sc, pool


@pytest.mark.parametrize("batch", [(16,), (2, 3, 4)], ids=["flat", "multidim"])
def test_wave_add_plain_matches_pallas_interpret(batch):
    curve = BN254
    n = int(np.prod(batch))
    ka, kp, neg, valid, zero_lane = _wave_case(curve, n, seed=60 + n)
    acc_host, pt_host = _host_points(curve, ka), _host_points(curve, kp)

    rops = ref_g1_ops(curve)
    racc, rpt = rops.encode_points(acc_host), rops.encode_points(pt_host)
    rpt = RefProjPoint(*(c.at[:, zero_lane].set(0) for c in rpt))
    shape = lambda c: c.reshape((c.shape[0],) + batch)  # noqa: E731
    ref = ec_wave_add_pallas(rops, RefProjPoint(*map(shape, racc)),
                             RefProjPoint(*map(shape, rpt)),
                             jnp.asarray(neg.reshape(batch)), jnp.asarray(valid.reshape(batch)),
                             interpret=True)
    ref_dec = rops.decode_points(RefProjPoint(*(c.reshape(c.shape[0], n) for c in ref)))

    pcurve = curve_by_name(curve.name)
    ops = g1_ops(pcurve, "cpu")
    f = ops.lane.f
    acc = ProjPoint(*(to_port(np.asarray(c)).reshape((f.L,) + batch) for c in racc))
    rows = torch.cat([to_port(np.asarray(c)) for c in rpt], dim=0).t().contiguous()
    assert rows.shape == (n, 3 * f.L)
    tneg, tvalid = torch.from_numpy(neg), torch.from_numpy(valid)
    got = ec_wave_add_plain(f, ops._b3_mont, acc, rows, tneg, tvalid)
    assert got.x.shape == (f.L,) + batch
    flat = ProjPoint(*(c.reshape(f.L, n) for c in got))
    assert ops.decode_points(flat) == ref_dec

    # what each kind of lane must give
    assert ref_dec[0] == pt_host[0]               # identity + P = P
    assert ref_dec[1] == acc_host[1]              # P + identity = P
    assert ref_dec[2] == _host_points(curve, [2 * int(ka[2])])[0]
    assert ref_dec[3] is None                     # P + (-P)
    assert ref_dec[4] == acc_host[4]              # -(identity) is the identity
    keep = torch.from_numpy(~valid)
    for g, a, r in zip(flat, acc, ref):
        assert torch.equal(g[:, keep], a.reshape(f.L, n)[:, keep])   # masked lanes: untouched
        # same formula on both sides: the projective limbs agree too
        assert same(g, np.asarray(r).reshape(r.shape[0], n))


@pytest.mark.parametrize("curve,wave", [(BN254, 0), (BN254, -1), (BLS12_381, 0)],
                         ids=["bn254_first", "bn254_last", "bls12_381_first"])
def test_whole_wave_matches_reference_wave_step(monkeypatch, curve, wave):
    """One whole wave, `MSM._wave_step` (G1) of both packages, with edge
    lanes: identity accumulators, doubling, inverse points, a point at
    infinity in the table, masked lanes and clamped positions past the
    chunk's end.  Over BLS12-381 the JAX package's wave step takes its XLA
    composition (negate, add, select), which its own tests hold equal to
    its kernel; over BN254 its Pallas kernel in interpret mode (the same
    padded shapes as the test above, so the compile is shared)."""
    pts_host, sc, pool = _wave_inputs(curve, 80 + curve.fq.p % 7)
    pcurve = curve_by_name(curve.name)
    ops = g1_ops(pcurve, "cpu")
    f = ops.lane.f
    fr = get_field(curve.fr.p, curve.name + ".fr", device="cpu")
    pts_host[11] = None                                    # the identity in the table
    eng = MSM(ops, c=WAVE_C, t=WAVE_T, scalar_bits=WAVE_BITS)
    digits, order, sortedb, bstart, n_waves = eng._prepare(fr.to_limbs(sc), WAVE_BITS, WAVE_C)
    nw, kp1 = bstart.shape
    w = 0 if wave == 0 else -(-int(n_waves) // WAVE_T) - 1
    src, neg, valid = add_wave_lanes(order, sortedb, digits, bstart, w, WAVE_T)
    lanes = nw * kp1 * WAVE_T
    acc_host = [pool[j % len(pool)] for j in range(lanes)]
    live = valid.nonzero().flatten().tolist()
    edges = live[:6] if wave == 0 else []
    for k, j in enumerate(edges):
        p = pts_host[int(src[j])]
        added = _neg(curve, p) if neg[j] else p
        acc_host[j] = [None, None, added, added, _neg(curve, added), _neg(curve, added)][k]
    assert (~valid).any() and live and (wave != 0 or len(edges) == 6)

    rops = ref_g1_ops(curve)
    rfr = ref_get_field(curve.fr.p, curve.name + ".fr")
    racc = rops.encode_points(acc_host)
    racc = RefProjPoint(*(c.reshape((c.shape[0], nw, kp1, WAVE_T)) for c in racc))
    rpts = rops.encode_points(pts_host)
    reng = RefMSM(rops, WAVE_C, WAVE_T, WAVE_BITS)
    rdig, rorder, rsorted, rstart, _, rn = reng._prepare(jnp.asarray(rfr.to_limbs(sc)),
                                                         WAVE_BITS, WAVE_C)
    assert int(rn) == int(n_waves)
    if curve is BN254:
        monkeypatch.setattr(type(rops.lane.f), "_pallas_ok", lambda self, a, b: True)
        monkeypatch.setattr(ref_pallas_curve, "ec_wave_add_pallas",
                            functools.partial(ref_pallas_curve.ec_wave_add_pallas, interpret=True))
    ref = reng._wave_step(reng._emajor(rpts), jax.tree.structure(rpts), rdig, rorder, rsorted,
                          rstart, w, racc)

    acc = ProjPoint(*(to_port(np.asarray(c)) for c in racc))
    pts_em = eng._emajor(ProjPoint(*(to_port(np.asarray(c)) for c in rpts)))
    got = ec_wave_add(ops, acc, pts_em, order, sortedb, digits, bstart, w)
    assert got.x.shape == (f.L, nw, kp1, WAVE_T)
    _compare(f.L, got, ref, acc, valid)
    if edges:
        dec = ops.decode_points(ProjPoint(*(c.reshape(f.L, -1)[:, edges] for c in got)))
        assert dec[:2] == [_neg(curve, pts_host[int(src[j])]) if neg[j]
                           else pts_host[int(src[j])] for j in edges[:2]]   # identity + P = P
        assert dec[4:] == [None, None]                                      # P + (-P)


def test_negation_of_a_zero_y_is_zero():
    """p - 0 must be 0, not p: an all-zero row stays all zero when negated."""
    ops = g1_ops(curve_by_name("bn254"), "cpu")
    f = ops.lane.f
    assert torch.equal(f.neg(f.zeros((3,))), f.zeros((3,)))


@pytest.mark.parametrize("n,zero_at", [(7, 2), (16, 9)])
def test_msm_fused_matches_reference_and_host(n, zero_at):
    curve = BN254
    R = curve.fr.p
    rng = random.Random(70 + n)
    ks = [rng.randrange(1, 60) for _ in range(n)]
    sc = [rng.randrange(R) for _ in range(n)]
    sc[zero_at] = 0
    total = sum(k * s for k, s in zip(ks, sc)) % R
    pts_host = _host_points(curve, ks)
    want = _host_points(curve, [total])[0]

    ops = g1_ops(curve_by_name("bn254"), "cpu")
    fr = get_field(R, "bn254.fr", device="cpu")
    eng = MSM(ops, c=6, t=2, scalar_bits=254)
    got = eng._msm_fused(ops.encode_points(pts_host), fr.to_limbs(sc), 254, 6)
    got = ops.decode_points(pmap(lambda c: c[:, None], got))[0]
    assert got == want
    assert eng._corr == {} and eng._Daff is None   # no salt, no correction on this path

    rops = ref_g1_ops(curve)
    rfr = ref_get_field(R, "bn254.fr")
    reng = RefMSM(rops, 6, 2, 254)
    ref = reng._msm_fused(rops.encode_points(pts_host), jnp.asarray(rfr.to_limbs(sc)), 254, 6)
    ref = rops.decode_points(jax.tree.map(lambda c: c[..., None], ref))[0]
    assert got == ref
