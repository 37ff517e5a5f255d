"""Port vs JAX package and host over BLS12-381: Fq has 12 limbs of 32 bits
(R = 2^384; the JAX package's 24 limbs of 16 bits repack pairwise), Fr has 8
with its own modulus and root tower.  Field, G1/G2 curve, wave add, MSM and
NTT against the JAX package after the repack.  Tolerance 0.  The Groth16
proof over this curve is in test_torch_bls12_381_groth16.py.

On the CPU the port runs the plain versions of the 12-limb kernels
(`mont_mul_plain`, `ec_add_plain`, `ec_madd_plain`, `ec_wave_add_plain`,
`ec_add_g2_plain`, `ec_wave_add_g2_plain`); the JAX side runs its XLA paths,
which its own tests hold equal to its Pallas kernels.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocircom_tpu.fields.ec_host import ec_mul
from cocircom_tpu.fields.params import BLS12_381
from cocircom_tpu.ops.curve import ProjPoint as RefPoint
from cocircom_tpu.ops.curve import g1_ops as ref_g1_ops
from cocircom_tpu.ops.curve import g2_ops as ref_g2_ops
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.ops.ntt import ntt_engine as ref_ntt_engine
from cocircom_tpu.pairing.tower import Tower
from cocircom_tpu_torch import convert
from cocircom_tpu_torch.fields.params import BLS12_381 as PBLS
from cocircom_tpu_torch.ops.curve import ec_wave_add, ec_wave_add_g2, g1_ops, g2_ops, leaves, pmap
from cocircom_tpu_torch.ops.field import get_field, mont_mul_plain
from cocircom_tpu_torch.ops.msm import MSM
from cocircom_tpu_torch.ops.ntt import ntt_engine
from torch_port_util import rand_ints, same, to_port

Q, R = BLS12_381.fq.p, BLS12_381.fr.p
T = Tower(BLS12_381)
G1H = (T.fp(BLS12_381.g1_gen[0]), T.fp(BLS12_381.g1_gen[1]))
(_x0, _x1), (_y0, _y1) = BLS12_381.g2_gen
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


def test_msm_g1_both_paths_match_host():
    """The G2 MSM over this curve, and the JAX package's MSMs, are held to the
    port's end to end by the proof in test_torch_bls12_381_groth16.py."""
    rng = random.Random(17)
    n = 7
    ks = [rng.randrange(1, 60) for _ in range(n)]
    sc = [rng.randrange(R) for _ in range(n)]
    sc[3] = 0
    total = sum(k * s for k, s in zip(ks, sc)) % R
    fr = get_field(R, "bls12_381.fr", device="cpu")
    ops = g1_ops(PBLS, "cpu")
    eng = MSM(ops, c=6, t=2, scalar_bits=255)
    pts, sl = ops.encode_points([h1(k) for k in ks]), fr.to_limbs(sc)
    dec = lambda o, r: o.decode_points(pmap(lambda c: c[:, None], r))[0]  # noqa: E731
    assert eng.use_madd
    assert dec(ops, eng.msm(pts, sl)) == h1(total)                      # mixed-add path
    assert dec(ops, eng._msm_fused(pts, sl, 255, 6)) == h1(total)       # complete-add path


def test_g1_add_scalar_mul_and_affine_match_reference():
    rops, ops = ref_g1_ops(BLS12_381), g1_ops(PBLS, "cpu")
    assert ops.lane.f.L == 12
    ks = [0, 5, 7, 9, 11, 13, 0, 21]
    js = [3, 5, R - 7, 2, 0, 40, 0, 1]      # identity, P+P, P+(-P), ...
    p = rops.encode_points([h1(k) for k in ks])
    q = rops.encode_points([h1(k) for k in js])
    got = ops.add(_to_port(p), _to_port(q))
    assert ops.decode_points(got) == [h1(a + b) for a, b in zip(ks, js)]
    assert ops.decode_points(got) == rops.decode_points(rops.add(p, q))
    sc = np.array([[11, 0, 5, 127, 1, 2, 3, 4]], np.uint32)
    ref = rops.decode_points(rops.scalar_mul(p, jnp.asarray(sc), 7))
    assert ops.decode_points(ops.scalar_mul(
        _to_port(p), torch.from_numpy(sc.astype(np.int32)), 7)) == ref
    ax, ay = ops.to_affine_limbs(_to_port(p))
    rax, ray = rops.to_affine_limbs(p)
    assert same(ax, rax) and same(ay, ray)


@pytest.mark.parametrize("p,name,limbs", [(Q, "bls12_381.fq", 12), (R, "bls12_381.fr", 8)])
def test_field_matches_reference_and_ints(p, name, limbs):
    rf = ref_get_field(p, name)
    f = get_field(p, name, device="cpu")
    assert f.L == limbs and rf.L == 2 * limbs and f.R == 1 << (32 * limbs)
    edge = [0, 1, p - 1, 2, p - 2]
    va = edge + rand_ints(p, 40, 1)
    vb = edge[::-1] + rand_ints(p, 40, 2)
    a16, b16 = jnp.asarray(rf.to_limbs(va)), jnp.asarray(rf.to_limbs(vb))
    a, b = to_port(a16), to_port(b16)
    got = mont_mul_plain(f, a, b)
    assert same(got, rf.mont_mul(a16, b16))
    r_inv = pow(f.R, -1, p)
    assert list(f.from_limbs(got)) == [x * y * r_inv % p for x, y in zip(va, vb)]
    assert same(f.mont_mul(a, b[:, :1]), rf.mont_mul(a16, b16[:, :1]))
    assert same(f.add(a, b), rf.add(a16, b16))
    assert same(f.sub(a, b), rf.sub(a16, b16))
    assert same(f.neg(a), rf.neg(a16))
    enc_ref, enc = rf.encode(va[:12]), f.encode(va[:12])
    assert same(enc, enc_ref)
    assert [int(v) for v in f.decode(enc)] == va[:12]
    assert same(f.batch_inv(enc), rf.batch_inv(enc_ref))
    assert same(f.sum(enc), rf.sum(enc_ref))
    data = np.random.default_rng(6).bytes(4 * limbs * 5)
    assert same(f.bytes_to_limbs(data, 5), rf.bytes_to_limbs(data, 5))
    assert len(f.kconsts) == 3 * limbs + 1


def test_g2_add_matches_reference_and_host():
    rops, ops = ref_g2_ops(BLS12_381), g2_ops(PBLS, "cpu")
    ks = [0, 5, 7, 9, 11]
    js = [3, 5, R - 7, 0, 2]
    p = rops.encode_points([h2(k) for k in ks])
    q = rops.encode_points([h2(k) for k in js])
    want = [h2(a + b) for a, b in zip(ks, js)]
    ref = rops.add(p, q)
    assert rops.decode_points(ref) == want
    got = ops.add(_to_port(p), _to_port(q))
    assert ops.decode_points(got) == want
    for g, r in zip(got, ref):          # the same three-wave formula on both sides
        assert same(g[0], r[0]) and same(g[1], r[1])


def test_wave_add_12_limbs_matches_reference_composition():
    """acc <- valid ? acc + (neg ? -pt : pt) : acc against the JAX package's
    negate + add + select (what its kernel is held to in its own tests)."""
    rops, ops = ref_g1_ops(BLS12_381), g1_ops(PBLS, "cpu")
    ka = [0, 9, 14, 17, 5, 8, 30, 31]
    kp = [4, 0, 14, 17, 0, 6, 2, 12]          # identity sides, doubling, inverse
    neg = np.array([0, 0, 0, 1, 1, 1, 1, 0], bool)
    valid = np.array([1, 1, 1, 1, 1, 0, 1, 0], bool)
    racc = rops.encode_points([h1(k) if k else None for k in ka])
    rpt = rops.encode_points([h1(k) if k else None for k in kp])
    rpt = RefPoint(*(c.at[:, 5].set(0) for c in rpt))         # masked lane, all-zero row
    ln = rops.lane
    sel = RefPoint(rpt.x, ln.select(jnp.asarray(neg), ln.neg(rpt.y), rpt.y), rpt.z)
    ref = rops.select(jnp.asarray(valid), rops.add(racc, sel), racc)

    acc = _to_port(racc)
    rows = torch.cat(list(_to_port(rpt)), dim=0).t().contiguous()
    assert rows.shape == (8, 36)
    got = ec_wave_add(ops, acc, rows, torch.from_numpy(neg), torch.from_numpy(valid))
    for g, r in zip(got, ref):
        assert same(g, r)
    signed = [(-k if s else k) for k, s in zip(kp, neg)]
    want = [h1(a + b) if v else h1(a) for a, b, v in zip(ka, signed, valid)]
    assert ops.decode_points(got) == [w if k or v else None
                                      for w, k, v in zip(want, ka, valid)]


def test_g2_wave_add_12_limbs_matches_reference_composition():
    """The G2 wave over 12-limb Fq2 against the JAX package's G2 wave
    (negate, add, select over its g2_ops)."""
    rops, ops = ref_g2_ops(BLS12_381), g2_ops(PBLS, "cpu")
    ka = [0, 9, 14, 17, 5, 8]
    kp = [4, 0, 14, 17, 6, 2]                 # identity sides, doubling, inverse
    neg = np.array([0, 0, 0, 1, 1, 1], bool)
    valid = np.array([1, 1, 1, 1, 0, 1], bool)
    racc = rops.encode_points([h2(k) if k else None for k in ka])
    rpt = rops.encode_points([h2(k) if k else None for k in kp])
    rpt = RefPoint(*((c[0].at[:, 4].set(0), c[1].at[:, 4].set(0)) for c in rpt))  # masked, zero row
    ln = rops.lane
    sel = RefPoint(rpt.x, ln.select(jnp.asarray(neg), ln.neg(rpt.y), rpt.y), rpt.z)
    ref = rops.select(jnp.asarray(valid), rops.add(racc, sel), racc)

    acc = _to_port(racc)
    rows = torch.cat(leaves(_to_port(rpt)), dim=0).t().contiguous()
    assert rows.shape == (6, 72)
    got = ec_wave_add_g2(ops, acc, rows, torch.from_numpy(neg), torch.from_numpy(valid))
    for g, r in zip(leaves(got), [t for c in ref for t in c]):
        assert same(g, r)
    signed = [(-k if s else k) for k, s in zip(kp, neg)]
    assert ops.decode_points(got) == [h2(a + b) if v else h2(a) if a else None
                                      for a, b, v in zip(ka, signed, valid)]


def test_ntt_over_bls_fr_matches_reference():
    """8 limbs like BN254 Fr, but another modulus and another root tower."""
    rf = ref_get_field(R, "bls12_381.fr")
    f = get_field(R, "bls12_381.fr", device="cpu")
    reng, eng = ref_ntt_engine(rf, BLS12_381.fr), ntt_engine(f, PBLS.fr)
    vals = rand_ints(R, 32, 9)
    ra = rf.to_mont(jnp.asarray(rf.to_limbs(vals)))
    a = f.encode(vals)
    assert same(a, ra)
    assert same(eng.ntt(a), reng.ntt(ra))
    assert same(eng.intt(a), reng.intt(ra))
    assert same(eng.coset_shift(a), reng.coset_shift(ra))
    assert torch.equal(eng.intt(eng.ntt(a)), a)
    # the four-step path (kernel K3's plain version) at the same size
    four = eng._fourstep(a[:, :, None].contiguous(), 5, False, 5).reshape(f.L, 32)
    assert torch.equal(four, eng.ntt(a))
