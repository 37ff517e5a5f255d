"""Port vs JAX package: curve arithmetic (kernels K4 and K5's plain
versions), tolerance 0 on the kernels' formulas, affine decode elsewhere.

The JAX side runs `ec_add_pallas` / `ec_madd_pallas` in interpret mode; the
port runs `ec_add_plain` / `ec_madd_plain` on the CPU.  Both transcribe the
same formulas, so even the projective coordinates agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import torch

from cocircom_tpu.fields.ec_host import ec_add, ec_mul
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.ops.curve import ProjPoint as RefPoint
from cocircom_tpu.ops.curve import g1_ops as ref_g1_ops
from cocircom_tpu.ops.curve import g2_ops as ref_g2_ops
from cocircom_tpu.ops.pallas_curve import ec_add_pallas, ec_madd_pallas
from cocircom_tpu.pairing.tower import Tower
from cocircom_tpu_torch import convert
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.ops.curve import ProjPoint, ec_madd_plain, g1_ops, g2_ops
from torch_port_util import same

R = BN254.fr.p
T = Tower(BN254)
G1H = (T.fp(1), T.fp(2))
(_x0, _x1), (_y0, _y1) = BN254.g2_gen
G2H = (T.fp2(_x0, _x1), T.fp2(_y0, _y1))


def h1(k):
    p = ec_mul(G1H, k % R)
    return None if p is None else (p[0].v, p[1].v)


def h2(k):
    p = ec_mul(G2H, k % R)
    return None if p is None else ((p[0].c0.v, p[0].c1.v), (p[1].c0.v, p[1].c1.v))


def _to_port(pt):
    return convert.points_from_reference(
        RefPoint(*[tuple(np.asarray(x) for x in c) if isinstance(c, tuple)
                   else np.asarray(c) for c in pt]), device="cpu")


def test_ec_add_plain_matches_pallas_bitwise():
    rops, ops = ref_g1_ops(BN254), g1_ops(PBN254, "cpu")
    ks = [0, 5, 7, 9, 11, 13, 0, 21]
    js = [3, 5, R - 7, 2, 0, 40, 0, 1]      # identity, P+P, P+(-P), ...
    p = rops.encode_points([h1(k) for k in ks])
    q = rops.encode_points([h1(k) for k in js])
    ref = ec_add_pallas(rops, p, q, interpret=True)
    got = ops.add(_to_port(p), _to_port(q))
    for g, r in zip(got, ref):
        assert same(g, r)
    assert ops.decode_points(got) == [h1(a + b) for a, b in zip(ks, js)]
    # a single point broadcast over the batch
    q1 = RefPoint(*(c[..., 3:4] for c in q))
    ref1 = ec_add_pallas(rops, p, q1, interpret=True)
    got1 = ops.add(_to_port(p), ProjPoint(*(c[:, 3] for c in _to_port(q))))
    for g, r in zip(got1, ref1):
        assert same(g, r)


def test_ec_madd_plain_matches_pallas_bitwise():
    rops, ops = ref_g1_ops(BN254), g1_ops(PBN254, "cpu")
    rf = rops.lane.f
    n = 12
    acc = rops.encode_points([h1(100 + i) for i in range(n)])
    pts = rops.encode_points([None if i in (2, 7) else h1(3 + i) for i in range(n)])
    ax, ay = rops.to_affine_limbs(pts)          # identity -> (0, 0) rows
    rows_ref = jnp.concatenate([ax, ay], axis=0).T          # (n, 2L) u16-in-u32
    valid = np.array([i not in (4, 7, 9) for i in range(n)])
    ref = ec_madd_pallas(rops, acc, rows_ref, None, jnp.asarray(valid),
                         interpret=True, packed=False)
    rows = torch.cat([convert.field_from_reference(np.asarray(ax), device="cpu"),
                      convert.field_from_reference(np.asarray(ay), device="cpu")], dim=0).t().contiguous()
    got = ec_madd_plain(ops.lane.f, _to_port(acc), rows, torch.from_numpy(valid))
    for g, r in zip(got, ref):
        assert same(g, r)
    # masked lanes and (0,0) rows pass through untouched
    for i in (2, 4, 7, 9):
        for g, a in zip(got, acc):
            assert same(g[:, i], np.asarray(a)[:, i])
    assert rf.L == 16


def test_scalar_mul_sum_suffix_sums_match_host():
    ops = g1_ops(PBN254, "cpu")
    ks = [3, 0, 8, 1, 15]
    p = ops.encode_points([h1(k) for k in ks])
    sc = [5, 9, 0, R - 1, 77]
    limbs = ops.lane.f.to_limbs([0]) * 0  # shape helper, Fq limbs unused below
    from cocircom_tpu_torch.ops.field import get_field

    fr = get_field(R, "bn254.fr", device="cpu")
    m = ops.scalar_mul(p, fr.to_limbs(sc)[:1], nbits=7)        # low 7 bits only
    assert ops.decode_points(m) == [h1(k * (s & 0x7F)) for k, s in zip(ks, sc)]
    assert ops.decode_points(ops.suffix_sums(p)) == [h1(sum(ks[i:])) for i in range(5)]
    total = ops.sum(p)
    assert ops.decode_points(ProjPoint(*(c[:, None] for c in total))) == [h1(sum(ks))]
    assert limbs.shape[0] == 8


def test_g1_matches_reference_ops():
    rops, ops = ref_g1_ops(BN254), g1_ops(PBN254, "cpu")
    ks = [2, 9, 0, 33]
    p = rops.encode_points([h1(k) for k in ks])
    sc = np.array([[11, 0, 5, 127]], np.uint32)
    ref = rops.decode_points(rops.scalar_mul(p, jnp.asarray(sc), 7))
    got = ops.decode_points(ops.scalar_mul(_to_port(p),
                                           torch.from_numpy(sc.astype(np.int32)), 7))
    assert got == ref
    ax, ay = ops.to_affine_limbs(_to_port(p))
    rax, ray = rops.to_affine_limbs(p)
    assert same(ax, rax) and same(ay, ray)


def test_g2_add_matches_reference_and_host():
    rops, ops = ref_g2_ops(BN254), g2_ops(PBN254, "cpu")
    ks = [0, 5, 7, 9, 11]
    js = [3, 5, R - 7, 0, 2]
    p = rops.encode_points([h2(k) for k in ks])
    q = rops.encode_points([h2(k) for k in js])
    want = [h2(a + b) for a, b in zip(ks, js)]
    assert rops.decode_points(rops.add(p, q)) == want
    got = ops.add(_to_port(p), _to_port(q))
    assert ops.decode_points(got) == want
    # same three-wave formula on both sides: coordinates agree bit for bit
    ref = rops.add(p, q)
    for g, r in zip(got, ref):
        assert same(g[0], r[0]) and same(g[1], r[1])
    host = ec_add(ec_mul(G2H, 5), ec_mul(G2H, 5))
    assert want[1] == ((host[0].c0.v, host[0].c1.v), (host[1].c0.v, host[1].c1.v))
