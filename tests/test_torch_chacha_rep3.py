"""Port vs JAX package: the ChaCha PRF and the REP3 primitives, with every
seed pinned in both packages; shares and openings must be equal bit for bit.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest

import cocircom_tpu.mpc.rep3 as ref_rep3
import cocircom_tpu_torch.mpc.rep3 as port_rep3
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.mpc.runner import run_parties as ref_run_parties
from cocircom_tpu.ops.curve import g1_ops as ref_g1_ops
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.utils.chacha import ChaChaStream as RefStream
from cocircom_tpu.utils.chacha import chacha_blocks as ref_blocks
from cocircom_tpu.utils.chacha import seed_to_words as ref_words
from cocircom_tpu_torch import convert
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.utils.chacha import ChaChaStream, chacha_blocks, seed_to_words
from torch_port_util import pin_rep3_seeds, rand_ints, run_named, same, to_port

P = BN254.fr.p


@pytest.mark.parametrize("seed", [7, b"\x05" * 32])
def test_chacha_stream_words_equal(seed):
    assert np.array_equal(np.asarray(ref_words(seed)),
                          seed_to_words(seed, device="cpu").numpy().astype(np.uint32))
    ref = ref_blocks(ref_words(seed), jnp.uint32(3), jnp.uint32(1), 5)
    got = chacha_blocks(seed_to_words(seed, device="cpu"), 3, 1, 5)
    assert np.array_equal(np.asarray(ref), got.numpy().astype(np.uint32))
    r, p = RefStream(seed, domain=2), ChaChaStream(seed, domain=2, device="cpu")
    for shape in ((3, 5), (40,), (2, 3, 4)):
        assert np.array_equal(np.asarray(r.words(shape)),
                              p.words(shape).numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(r.limbs16((6, 7))),
                          p.limbs16((6, 7)).numpy().astype(np.uint32))
    assert r.ctr == p.ctr


def test_rand_mont_and_share_field_vec_equal():
    rf = ref_get_field(P, "bn254.fr")
    f = get_field(P, "bn254.fr", device="cpu")
    r, p = RefStream(9), ChaChaStream(9, device="cpu")
    assert same(p.rand_mont(f, (11,)), r.rand_mont(rf, (11,)))
    assert same(p.rand_mont(f, ()), r.rand_mont(rf, ()))
    vec = rf.encode(rand_ints(P, 9, 3))
    ref_sh = ref_rep3.share_field_vec(rf, vec, seed=77)
    sh = port_rep3.share_field_vec(f, to_port(vec), seed=77)
    for s, rs in zip(sh, ref_sh):
        assert same(s.a, rs.a) and same(s.b, rs.b)
    assert same(port_rep3.combine_field_shares(f, sh), vec)
    back = convert.rep3_share_from_reference((np.asarray(ref_sh[1].a), np.asarray(ref_sh[1].b)),
                                             device="cpu")
    assert bool((back.a == sh[1].a).all()) and bool((back.b == sh[1].b).all())


def test_mul_vec_open_many_open_point_equal(monkeypatch):
    pin_rep3_seeds(monkeypatch, ref_rep3, port_rep3)
    rf = ref_get_field(P, "bn254.fr")
    f = get_field(P, "bn254.fr", device="cpu")
    xs, ys = rand_ints(P, 6, 1), rand_ints(P, 6, 2)
    rx = ref_rep3.share_field_vec(rf, rf.encode(xs), seed=1)
    ry = ref_rep3.share_field_vec(rf, rf.encode(ys), seed=2)
    px = port_rep3.share_field_vec(f, f.encode(xs), seed=1)
    py = port_rep3.share_field_vec(f, f.encode(ys), seed=2)

    def ref_party(i, net):
        d = ref_rep3.Rep3Driver(BN254, net)
        z = d.mul_vec(rx[i], ry[i])
        opened = d.open_many(z)
        gen = d.g1.encode_points([BN254.g1_gen])
        pt = d.scalar_mul_public_point(d.g1, gen, ref_rep3.Rep3FieldShare(z.a[:, :1], z.b[:, :1]))
        return z, opened, d.g1.decode_points(d.open_point(d.g1, pt))

    def port_party(i, net):
        d = port_rep3.Rep3Driver(PBN254, net, device="cpu")
        z = d.mul_vec(px[i], py[i])
        opened = d.open_many(z)
        gen = d.g1.encode_points([PBN254.g1_gen])
        pt = d.scalar_mul_public_point(d.g1, gen, port_rep3.Rep3FieldShare(z.a[:, :1], z.b[:, :1]))
        return z, opened, d.g1.decode_points(d.open_point(d.g1, pt))

    ref = run_named(ref_run_parties, ref_party)
    got = run_named(run_parties, port_party)
    want = [x * y % P for x, y in zip(xs, ys)]
    for (z, o, pt), (rz, ro, rpt) in zip(got, ref):
        assert same(z.a, rz.a) and same(z.b, rz.b)
        assert same(o, ro)
        assert [int(v) for v in f.decode(o)] == want
        assert pt == rpt
    rg1 = ref_g1_ops(BN254)
    host = rg1.decode_points(rg1.scalar_mul(
        rg1.encode_points([BN254.g1_gen]), jnp.asarray(rf.to_limbs([want[0]]))))
    assert got[0][2] == host


def test_run_parties_raises_a_partys_error_without_waiting_for_its_peers():
    """Party 1 fails before it sends; its peers sit at a receive that nobody
    will answer.  The error must surface at once, not at the receive's
    time limit."""
    def party(i, net):
        if i == 1:
            raise ValueError("party 1 failed")
        return net.recv_prev()

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="party 1 failed"):
        run_parties(party)
    assert time.monotonic() - t0 < 30
