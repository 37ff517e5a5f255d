"""Port vs JAX package and host: the masked complete add of the MSM wave
(`ec_wave_add`) and the complete-add MSM that runs it (`MSM._msm_fused`).

The JAX side runs `ec_wave_add_pallas` in interpret mode, as its own tests
do on the CPU; the port runs `ec_wave_add_plain` (the CUDA kernel's plain
version) through the wrapper, which takes it because the tensors lie on the
CPU.  Inputs are made from a seed with numpy; points are compared by affine
decode, untouched lanes bit for bit.  Tolerance 0.  The 12-limb case is in
test_torch_bls12_381.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocircom_tpu.fields.ec_host import ec_mul
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.ops.curve import ProjPoint as RefProjPoint
from cocircom_tpu.ops.curve import g1_ops as ref_g1_ops
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.ops.msm import MSM as RefMSM
from cocircom_tpu.ops.pallas_curve import ec_wave_add_pallas
from cocircom_tpu.pairing.tower import Tower
from cocircom_tpu_torch.fields.params import curve_by_name
from cocircom_tpu_torch.ops.curve import ProjPoint, ec_wave_add, ec_wave_add_plain, g1_ops, pmap
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.ops.msm import MSM
from torch_port_util import same, to_port


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
    got = ec_wave_add(ops, acc, rows, tneg, tvalid)
    again = ec_wave_add_plain(f, ops._b3_mont, acc, rows, tneg, tvalid)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
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
