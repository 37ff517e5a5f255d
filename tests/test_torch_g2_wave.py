"""Port vs JAX package: the G2 wave of the complete-add MSM
(`ec_wave_add_g2`, acc <- valid ? acc + (neg ? -pt : pt) : acc over Fq2).

The JAX side is its own G2 wave, an XLA composition (cocircom_tpu/ops/msm.py,
`MSM._wave_step`: select of y, `CurveOps.add`, select by `valid`, over
`g2_ops`); the port runs `ec_wave_add_g2_plain` (the CUDA kernel's plain
version) through the wrapper, which takes it because the tensors lie on the
CPU.  Inputs are made from a seed with numpy; points are compared by affine
decode, masked lanes bit for bit, and the projective limbs too (the same
formula on both sides).  Tolerance 0.  The 12-limb case is in
test_torch_bls12_381.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocircom_tpu.fields.ec_host import ec_mul
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.ops.curve import ProjPoint as RefPoint
from cocircom_tpu.ops.curve import g2_ops as ref_g2_ops
from cocircom_tpu.pairing.tower import Tower
from cocircom_tpu_torch import convert
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.ops import msm as port_msm
from cocircom_tpu_torch.ops.curve import (CurveOps, ec_wave_add_g2, ec_wave_add_g2_plain, g2_ops,
                                          leaves)
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.ops.msm import MSM
from torch_port_util import same

R = BN254.fr.p
TW = Tower(BN254)
(_x0, _x1), (_y0, _y1) = BN254.g2_gen
G2H = (TW.fp2(_x0, _x1), TW.fp2(_y0, _y1))


def h2(k):
    p = ec_mul(G2H, int(k) % R) if k else None
    return None if p is None else ((p[0].c0.v, p[0].c1.v), (p[1].c0.v, p[1].c1.v))


def _wave_case(n, seed):
    """Lanes of every kind (as in test_torch_wave_add.py): returns (acc
    multipliers, point multipliers, neg, valid, lane whose row is zero)."""
    rng = np.random.default_rng(seed)
    ka = rng.integers(1, 1 << 10, size=n)
    kp = rng.integers(1, 1 << 10, size=n)
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
    valid[7] = False                              # masked lane, ordinary row
    return ka, kp, neg, valid, 5


def _port_point(ref_pt):
    return convert.points_from_reference(
        RefPoint(*[tuple(np.asarray(x) for x in c) for c in ref_pt]), device="cpu")


def test_g2_wave_plain_matches_reference_composition():
    n = 16
    ka, kp, neg, valid, zero_lane = _wave_case(n, seed=90)
    acc_host, pt_host = [h2(k) for k in ka], [h2(k) for k in kp]

    rops = ref_g2_ops(BN254)
    racc, rpt = rops.encode_points(acc_host), rops.encode_points(pt_host)
    rpt = RefPoint(*((c[0].at[:, zero_lane].set(0), c[1].at[:, zero_lane].set(0)) for c in rpt))
    ln = rops.lane
    jneg, jvalid = jnp.asarray(neg), jnp.asarray(valid)
    sel = RefPoint(rpt.x, ln.select(jneg, ln.neg(rpt.y), rpt.y), rpt.z)
    ref = rops.select(jvalid, rops.add(racc, sel), racc)
    ref_dec = rops.decode_points(ref)

    ops = g2_ops(PBN254, "cpu")
    L = ops.lane.f.L
    acc = _port_point(racc)
    rows = torch.cat(leaves(_port_point(rpt)), dim=0).t().contiguous()
    assert rows.shape == (n, 6 * L)
    tneg, tvalid = torch.from_numpy(neg), torch.from_numpy(valid)
    got = ec_wave_add_g2(ops, acc, rows, tneg, tvalid)
    again = ec_wave_add_g2_plain(ops, acc, rows, tneg, tvalid)
    assert all(torch.equal(g, a) for g, a in zip(leaves(got), leaves(again)))
    assert ops.decode_points(got) == ref_dec

    # what each kind of lane must give
    assert ref_dec[0] == pt_host[0]               # identity + P = P
    assert ref_dec[1] == acc_host[1]              # P + identity = P
    assert ref_dec[2] == h2(2 * int(ka[2]))
    assert ref_dec[3] is None                     # P + (-P)
    assert ref_dec[4] == acc_host[4]              # -(identity) is the identity
    assert ref_dec[6] == h2(int(ka[6]) - int(kp[6]))
    keep = torch.from_numpy(~valid)
    ref_leaves = [t for c in ref for t in c]
    for g, a, r in zip(leaves(got), leaves(acc), ref_leaves):
        assert torch.equal(g[:, keep], a[:, keep])        # masked lanes: untouched
        assert same(g, r)                                 # projective limbs agree


def test_msm_g2_waves_run_one_fused_wave_each(monkeypatch):
    """Every G2 wave of the complete-add path is ONE `ec_wave_add_g2` call:
    no `CurveOps.add` and no `CurveOps.select` of its own."""
    ops = g2_ops(PBN254, "cpu")
    fr = get_field(R, "bn254.fr", device="cpu")
    eng = MSM(ops, c=4, t=2, scalar_bits=254)
    ks = [3, 5, 7, 11, 13]
    sc = [9, R - 2, 0, 12345, 7]
    calls = {"wave": 0, "add": 0, "select": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def wave(ops_, acc, rows, neg, valid):
        """Stands in for the wave (whose plain version adds and selects
        itself): checks what `_wave_step` hands it, counts, returns acc."""
        lanes = 64 * 9 * 2                      # windows x (K + 1) x T
        assert ops_ is ops and rows.shape == (lanes, 6 * 8)
        assert neg.dtype == valid.dtype == torch.bool and neg.shape == valid.shape == (lanes,)
        calls["wave"] += 1
        return acc

    monkeypatch.setattr(port_msm, "ec_wave_add_g2", wave)
    monkeypatch.setattr(CurveOps, "add", spy("add", CurveOps.add))
    monkeypatch.setattr(CurveOps, "select", spy("select", CurveOps.select))
    [acc] = eng._accumulate(ops.encode_points([h2(k) for k in ks]), [fr.to_limbs(sc)], 254, 4,
                            madd=False)
    assert eng.last_waves > 0
    assert calls == {"wave": eng.last_waves, "add": 0, "select": 0}
    assert all(c.shape == (8, 64, 9, 2) for c in leaves(acc))   # (L, windows, K + 1, T)


@pytest.mark.parametrize("bad", ["five_coordinates", "row_width", "mask_length", "mask_dtype",
                                 "cpu_tensors"])
def test_g2_wave_wrapper_refuses(bad):
    """The CUDA wrapper raises on what its kernel does not take, and on CPU
    tensors, instead of falling back to the plain version."""
    from cocircom_tpu_torch.ops import kernels

    n, L = 4, 8
    acc = [torch.zeros((L, n), dtype=torch.int32) for _ in range(6)]
    rows = torch.zeros((n, 6 * L), dtype=torch.int32)
    neg = torch.zeros(n, dtype=torch.bool)
    valid = torch.ones(n, dtype=torch.bool)
    consts = get_field(BN254.fq.p, "bn254.fq", device="cpu").kconsts
    msg = "CUDA tensor"
    if bad == "five_coordinates":
        acc, msg = acc[:5], "6 coordinate"
    elif bad == "row_width":
        rows, msg = torch.zeros((n, 3 * L), dtype=torch.int32), "rows must be"
    elif bad == "mask_length":
        neg, msg = torch.zeros(n + 1, dtype=torch.bool), "neg must be"
    elif bad == "mask_dtype":
        valid, msg = torch.ones(n, dtype=torch.uint8), "valid must be"
    with pytest.raises(ValueError, match=msg):
        kernels.ec_wave_add_g2(acc, rows, neg, valid, consts)
    assert kernels.launch_counts()["ec_wave_add_g2"] == 0
