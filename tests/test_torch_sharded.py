"""Port vs JAX package, host and the port's own one-device engines: the
device-sharded MSM, NTT and prover core (cocircom_tpu_torch/parallel/sharded.py)
over a list that names the CPU several times, and the forms of a driver's
`device` / `devices` arguments.  The proofs through `devices=` are in
test_torch_devices_proofs.py.

The cases are those of tests/test_sharded.py, which needs eight virtual JAX
devices; here the JAX package runs its one-device engines, which its
sharded ones are held equal to there.  Tolerance 0: points by affine decode,
field elements by limbs after the repack.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocircom_tpu.fields.ec_host import ec_mul
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.ops.curve import g1_ops as ref_g1_ops
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.ops.msm import MSM as RefMSM
from cocircom_tpu.ops.ntt import ntt_engine as ref_ntt_engine
from cocircom_tpu.pairing.tower import Tower
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.mpc.driver import PlainDriver
from cocircom_tpu_torch.ops.curve import ProjPoint, g1_ops, g2_ops, pmap
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.ops.msm import MSM, msm_engine
from cocircom_tpu_torch.ops.ntt import ntt_engine
from cocircom_tpu_torch.parallel import sharded
from torch_port_util import same, small_msm_engines

R = BN254.fr.p
CPU = torch.device("cpu")
TW = Tower(BN254)
G1H = (TW.fp(1), TW.fp(2))


def h1(k):
    p = ec_mul(G1H, k % R)
    return None if p is None else (p[0].v, p[1].v)


@pytest.fixture()
def small_engines(monkeypatch):
    restore = small_msm_engines(monkeypatch)
    yield
    restore()


def _msm_case(n, seed):
    rng = random.Random(seed)
    ks = [rng.randrange(1, 60) for _ in range(n)]
    sc = [rng.randrange(R) for _ in range(n)]
    sc[n // 2] = 0
    return ks, sc, sum(k * s for k, s in zip(ks, sc)) % R


@pytest.mark.parametrize("n,n_dev", [(16, 4), (13, 3)], ids=["16-over-4", "13-over-3"])
def test_sharded_msm_matches_host_local_and_reference(small_engines, n, n_dev):
    """n = 13 over 3 devices is padded by two zero scalars, which must never
    enter a bucket; a shard's window width comes from its own point count."""
    ks, sc, total = _msm_case(n, 50 + n)
    ops = g1_ops(PBN254, CPU)
    fr = get_field(R, "bn254.fr", device=CPU)
    pts, sl = ops.encode_points([h1(k) for k in ks]), fr.to_limbs(sc)
    eng = sharded.ShardedMSMEngine(lambda d: g1_ops(PBN254, d), [CPU] * n_dev, scalar_bits=254)
    got = ops.decode_points(pmap(lambda c: c[:, None], eng.msm(pts, sl)))[0]
    assert got == h1(total)
    assert eng.last_waves > 0
    local = msm_engine(ops, scalar_bits=254).msm(pts, sl)
    assert got == ops.decode_points(pmap(lambda c: c[:, None], local))[0]
    fn = sharded.sharded_msm(lambda d: g1_ops(PBN254, d), [CPU] * n_dev, scalar_bits=254)
    assert ops.decode_points(pmap(lambda c: c[:, None], fn(pts, sl)))[0] == got

    if n_dev == 4:      # the JAX package's engine on the same points and scalars
        rops = ref_g1_ops(BN254)
        rfr = ref_get_field(R, "bn254.fr")
        ref = RefMSM(rops, None, 2, 254).msm(rops.encode_points([h1(k) for k in ks]),
                                             jnp.asarray(rfr.to_limbs(sc)))
        assert got == rops.decode_points(jax.tree.map(lambda c: c[..., None], ref))[0]


def test_prover_core_step_matches_local_engine_and_host(small_engines):
    n = 16
    rng = random.Random(52)
    f = get_field(R, "bn254.fr", device=CPU)
    ops = g1_ops(PBN254, CPU)
    hostP = [h1(k + 1) for k in range(n)]
    P = ops.encode_points(hostP)
    va, vb, vc = ([rng.randrange(R) for _ in range(n)] for _ in range(3))
    a, b, c = f.encode(va), f.encode(vb), f.encode(vc)
    rx, ry, rz = sharded.prover_core_step(PBN254, [CPU] * 4)(a, b, c, P.x, P.y, P.z)
    got = ops.decode_points(ProjPoint(rx[:, None], ry[:, None], rz[:, None]))[0]

    h = [(x * y - z) % R for x, y, z in zip(va, vb, vc)]
    assert got == h1(sum((k + 1) * s for k, s in enumerate(h)) % R)
    want = msm_engine(ops, scalar_bits=254).msm(P, f.from_mont(f.sub(f.mont_mul(a, b), c)))
    assert got == ops.decode_points(pmap(lambda t: t[:, None], want))[0]

def test_sharded_msm_many_and_small_sizes_go_local(small_engines):
    ops = g1_ops(PBN254, CPU)
    fr = get_field(R, "bn254.fr", device=CPU)
    eng = sharded.ShardedMSMEngine(lambda d: g1_ops(PBN254, d), [CPU] * 2, scalar_bits=254)
    ks, sa, ta = _msm_case(9, 61)
    _, sb, _ = _msm_case(9, 62)
    tb = sum(k * s for k, s in zip(ks, sb)) % R
    pts = ops.encode_points([h1(k) for k in ks])
    res = eng.msm_many(pts, [fr.to_limbs(sa), fr.to_limbs(sb)])
    assert ops.decode_points(res) == [h1(ta), h1(tb)]
    # 7 points over 2 devices: fewer than 4 each, the local engine's salted
    # mixed-add path takes the call
    local = eng.local
    before = local._Daff
    ks, sc, total = _msm_case(7, 63)
    res = eng.msm(ops.encode_points([h1(k) for k in ks]), fr.to_limbs(sc))
    assert ops.decode_points(pmap(lambda c: c[:, None], res))[0] == h1(total)
    assert before is not None or local._Daff is not None


def test_sharded_g2_msm_matches_host(small_engines):
    (x0, x1), (y0, y1) = BN254.g2_gen
    g2h = (TW.fp2(x0, x1), TW.fp2(y0, y1))

    def h2(k):
        p = ec_mul(g2h, k % R)
        return None if p is None else ((p[0].c0.v, p[0].c1.v), (p[1].c0.v, p[1].c1.v))

    rng = random.Random(81)
    ks = [rng.randrange(1, 60) for _ in range(9)]
    sc = [rng.randrange(R) for _ in range(9)]
    sc[4] = 0
    total = sum(k * s for k, s in zip(ks, sc)) % R
    ops = g2_ops(PBN254, CPU)
    fr = get_field(R, "bn254.fr", device=CPU)
    eng = sharded.ShardedMSMEngine(lambda d: g2_ops(PBN254, d), [CPU] * 2, scalar_bits=254)
    res = eng.msm(ops.encode_points([h2(k) for k in ks]), fr.to_limbs(sc))
    assert ops.decode_points(pmap(lambda c: c[:, None], res))[0] == h2(total)


@pytest.mark.parametrize("n_dev", [4, 3])
def test_sharded_ntt_and_intt_bit_equal_to_local_and_reference(n_dev):
    """Even and odd log sizes; three devices cut both axes unevenly."""
    f = get_field(R, "bn254.fr", device=CPU)
    local = ntt_engine(f, PBN254.fr)
    dist = sharded.ShardedNTTEngine(f, PBN254.fr, [CPU] * n_dev)
    rf = ref_get_field(R, "bn254.fr")
    reng = ref_ntt_engine(rf, BN254.fr)
    rng = random.Random(7 + n_dev)
    for logn in (6, 7):
        assert logn >= dist.min_log
        vals = [rng.randrange(R) for _ in range(1 << logn)]
        a = f.encode(vals)
        ra = rf.to_mont(jnp.asarray(rf.to_limbs(vals)))
        fwd, inv = dist.ntt(a), dist.intt(a)
        assert torch.equal(fwd, local.ntt(a)) and torch.equal(inv, local.intt(a))
        assert same(fwd, np.asarray(reng.ntt(ra))) and same(inv, np.asarray(reng.intt(ra)))
        assert torch.equal(dist.ntt(inv), a)
    small = f.encode([rng.randrange(R) for _ in range(1 << (dist.min_log - 1))])
    assert torch.equal(dist.ntt(small), local.ntt(small))      # too small to shard
    assert torch.equal(dist.coset_shift(a), local.coset_shift(a))
    assert torch.equal(sharded.sharded_ntt(f, PBN254.fr, [CPU] * n_dev)(a), local.ntt(a))


def test_shard_points_and_mul_vec():
    ops = g1_ops(PBN254, CPU)
    fr = get_field(R, "bn254.fr", device=CPU)
    pts = ops.encode_points([h1(k) for k in range(1, 8)])
    parts = sharded.shard_points([CPU] * 3, pts)
    assert [p.x.shape[1] for p in parts] == [2, 2, 3]
    back = pmap(lambda *cs: torch.cat(cs, dim=1), *parts)
    assert all(torch.equal(a, b) for a, b in zip(back, pts))
    rng = random.Random(5)
    a = fr.encode([rng.randrange(R) for _ in range(11)])
    b = fr.encode([rng.randrange(R) for _ in range(11)])
    assert torch.equal(sharded.sharded_mul_vec(fr, [CPU] * 4)(a, b), fr.mont_mul(a, b))


def test_driver_device_arguments():
    """One device in the list is no sharding; `device` and `devices` together
    are refused; the sharded NTT engine is shared per device tuple."""
    d1 = PlainDriver(PBN254, devices=[CPU])
    assert isinstance(d1.msm_g1_engine, MSM) and d1.devices is None and d1.device == CPU
    with pytest.raises(ValueError, match="not both"):
        PlainDriver(PBN254, device=CPU, devices=[CPU] * 2)
    a, b = PlainDriver(PBN254, devices=[CPU] * 3), PlainDriver(PBN254, devices=["cpu"] * 3)
    assert a.ntt is b.ntt and a.ntt.n_dev == 3 and a.devices == (CPU,) * 3
    assert a.ntt is not PlainDriver(PBN254, devices=[CPU] * 2).ntt
