"""Port vs JAX package: the REP3 binary domain (mpc/rep3_binary.py).

Over BN254, with every PRF seed pinned in both packages, the port's binary
and arithmetic share components equal the JAX package's after the limb
repack (tolerance 0).  Over BLS12-381 Fr the port is held to Python
integers instead: the JAX package's binary shares hold 256 bits, one too
few there (see `test_bls12_381_binary_ops_equal_integers`).

The JAX REP3 runs come first in the file; the cheap shift cases last.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import cocircom_tpu.mpc.rep3 as ref_rep3
import cocircom_tpu_torch.mpc.rep3 as port_rep3
from cocircom_tpu.fields.params import BN254 as RBN254
from cocircom_tpu.mpc.rep3_binary import shl_bits as ref_shl
from cocircom_tpu.mpc.rep3_binary import shr_bits as ref_shr
from cocircom_tpu.mpc.runner import run_parties as ref_run_parties
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu_torch import convert
from cocircom_tpu_torch.fields.params import BLS12_381, BN254
from cocircom_tpu_torch.mpc.rep3_binary import binary_limbs, shl_bits, shr_bits
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.ops.field import get_field, limbs_np_to_ints
from torch_port_util import PARTY_SEEDS, pin_rep3_seeds, rand_ints, run_named, same, to_port

N_VALUES = 18


def edge_values(p: int, seed: int) -> list:
    """The 18 inputs: 12 random, then 0, 1, p-1, p-2, p//2 and 2^254+5
    reduced mod p."""
    return rand_ints(p, 12, seed) + [0, 1, p - 1, p - 2, p // 2, ((1 << 254) + 5) % p]


def _ints(f, limbs) -> list:
    return [int(v) for v in f.from_limbs(limbs)]


def _binary_program(d, f, xs, ys, conv):
    """The ops under test on one party's shares; returns every share made,
    as (name, component a, component b) with the components passed
    through `conv`, and the opened values."""
    b = d.binary
    bx, by = b.a2b(xs), b.a2b(ys)
    ge = b.unsigned_ge(xs, ys)
    zero = b.is_zero(bx)
    ge_arith = b.bit_inject(ge)
    back = b.b2a(bx)
    full = b._maskc(b.bitlen, ge.a.shape[1:])
    ge_full = type(ge)(-ge.a[:1] & full, -ge.b[:1] & full)  # the bit spread to every bit
    mux = b.cmux(ge_full, bx, by)
    shares = [("a2b", bx), ("ge", ge), ("is_zero", zero), ("bit_inject", ge_arith),
              ("b2a", back), ("cmux", mux)]
    opened = {"a2b": b.open(bx), "ge": b.open(ge), "is_zero": b.open(zero),
              "cmux": b.open(mux), "bit_inject": f.from_mont(d.open_many(ge_arith)),
              "b2a": f.from_mont(d.open_many(back))}
    return [(n, conv(s.a), conv(s.b)) for n, s in shares], opened


def _want(x, y):
    return {"a2b": x, "ge": [int(a >= c) for a, c in zip(x, y)],
            "is_zero": [int(a == 0) for a in x], "bit_inject": [int(a >= c) for a, c in zip(x, y)],
            "b2a": x, "cmux": [a if a >= c else c for a, c in zip(x, y)]}


def test_bn254_binary_ops_equal_reference(monkeypatch):
    """a2b + open, unsigned_ge, is_zero, bit_inject, b2a and cmux over the 18
    values: every share component equal to the JAX package's, party by
    party, and every opened value equal to Python integers."""
    pin_rep3_seeds(monkeypatch, ref_rep3, port_rep3)
    p = RBN254.fr.p
    x, y = edge_values(p, 81), edge_values(p, 82)[::-1]
    rf = ref_get_field(p, "bn254.fr")
    f = get_field(p, "bn254.fr", device="cpu")
    rxs = ref_rep3.share_field_vec(rf, rf.encode(x), seed=83)
    rys = ref_rep3.share_field_vec(rf, rf.encode(y), seed=84)
    pxs = port_rep3.share_field_vec(f, f.encode(x), seed=83)
    pys = port_rep3.share_field_vec(f, f.encode(y), seed=84)

    def ref_party(i, net):
        d = ref_rep3.Rep3Driver(RBN254, net)
        shares, opened = _binary_program(d, rf, rxs[i], rys[i], np.asarray)
        return shares, {k: [int(v) for v in rf.from_limbs(o)] for k, o in opened.items()}, \
            d.rngs.bin1.ctr, d.rngs.bit1.ctr

    def port_party(i, net):
        d = port_rep3.Rep3Driver(BN254, net, device="cpu")
        assert d.binary.L == 8 == binary_limbs(254)
        shares, opened = _binary_program(d, f, pxs[i], pys[i], lambda t: t)
        return shares, {k: _ints(f, o) for k, o in opened.items()}, \
            d.rngs.bin1.ctr, d.rngs.bit1.ctr

    ref = run_named(ref_run_parties, ref_party)
    got = run_named(run_parties, port_party)
    want = _want(x, y)
    for (shares, opened, bin_ctr, bit_ctr), (rshares, ropened, rbin, rbit) in zip(got, ref):
        assert (bin_ctr, bit_ctr) == (rbin, rbit)
        for (name, a, b), (rname, ra, rb) in zip(shares, rshares):
            assert name == rname
            assert same(a, ra) and same(b, rb), name
        assert opened == ropened == want


def test_binary_share_conversion_round_trip():
    rf = ref_get_field(RBN254.fr.p, "bn254.fr")
    vals = rand_ints(RBN254.fr.p, 5, 85)
    a = np.asarray(rf.to_limbs(vals))
    b = np.asarray(rf.to_limbs(vals[::-1]))
    sh = convert.binary_share_from_reference((a, b), device="cpu")
    back = convert.binary_share_to_reference(sh)
    assert np.array_equal(back[0], a) and np.array_equal(back[1], b)
    wide = convert.binary_share_from_reference((a, b), device="cpu", limbs=9)
    assert wide.a.shape == (9, 5) and not bool(wide.a[8].any())
    assert bool((wide.a[:8] == sh.a).all())


def test_bls12_381_binary_ops_equal_integers():
    """Over BLS12-381 Fr (255 bits) the port's binary shares hold 9 limbs
    (bitlen + 2 = 257 bits).  The JAX package's hold 256, so its
    `sub_p_cmux` (mpc/rep3_binary.py:285-302) reads its overflow bit at bit
    256, outside the share, always as 0: a sum in [p, 2p) is not reduced
    and a2b returns x + p for some x (0 came back as p).  So the port is
    held to Python integers here, not to the JAX package."""
    p = BLS12_381.fr.p
    x, y = edge_values(p, 86), edge_values(p, 87)[::-1]
    f = get_field(p, "bls12_381.fr", device="cpu")
    xs = port_rep3.share_field_vec(f, f.encode(x), seed=88)
    ys = port_rep3.share_field_vec(f, f.encode(y), seed=89)

    def party(i, net):
        d = port_rep3.Rep3Driver(BLS12_381, net, device="cpu")
        assert d.binary.L == 9 == binary_limbs(255)
        _, opened = _binary_program(d, f, xs[i], ys[i], lambda t: t)
        return {k: _ints(f, o) for k, o in opened.items()}

    for opened in run_parties(party):
        assert opened == _want(x, y)


def test_arithmetic_bit_ops_and_and_twice_equal_integers():
    """shr_arith, bitwise_arith (band, bor, bxor) and and_twice, over BN254,
    against Python integers."""
    p = BN254.fr.p
    x, y = rand_ints(p, 4, 90), rand_ints(p, 4, 91)
    f = get_field(p, "bn254.fr", device="cpu")
    xs = port_rep3.share_field_vec(f, f.encode(x), seed=92)
    ys = port_rep3.share_field_vec(f, f.encode(y), seed=93)

    def party(i, net):
        d = port_rep3.Rep3Driver(BN254, net, device="cpu")
        b = d.binary
        out = {"shr": b.shr_arith(xs[i], 37)}
        for op in ("band", "bor", "bxor"):
            out[op] = b.bitwise_arith(op, xs[i], ys[i])
        res = {k: [int(v) for v in f.decode(d.open_many(s))] for k, s in out.items()}
        bx, by = b.a2b(xs[i]), b.a2b(ys[i])
        t1, t2 = b.and_twice(bx, by, bx)
        res["and_twice"] = (_ints(f, b.open(t1)), _ints(f, b.open(t2)))
        return res

    want = {"shr": [v >> 37 for v in x], "band": [a & c for a, c in zip(x, y)],
            "bor": [(a | c) % p for a, c in zip(x, y)], "bxor": [(a ^ c) % p for a, c in zip(x, y)],
            "and_twice": ([a & c for a, c in zip(x, y)], x)}
    for res in run_parties(party):
        assert res == want


def test_binary_masks_equal_reference():
    """Two draws of two masks over (3, 5): each the JAX package's
    `binary_masks` after the repack, the streams advanced as far."""
    p = RBN254.fr.p
    rf = ref_get_field(p, "bn254.fr")
    f = get_field(p, "bn254.fr", device="cpu")
    r = ref_rep3.Rep3Rngs(PARTY_SEEDS[0], PARTY_SEEDS[1])
    t = port_rep3.Rep3Rngs(PARTY_SEEDS[0], PARTY_SEEDS[1], device="cpu")
    for shape, n in (((3, 5), 2), ((7,), 1)):
        got = t.binary_masks(f, 254, shape, n)
        want = r.binary_masks(rf, 254, shape, n)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert g.shape == (8,) + shape and same(g, w)
        assert (t.bin1.ctr, t.bin2.ctr) == (r.bin1.ctr, r.bin2.ctr)


SHIFTS = (1, 5, 16, 23, 31, 32, 33, 128, 224, 253, 255)


@pytest.mark.parametrize("s", SHIFTS)
def test_limb_shifts_equal_reference(s):
    """Both shifts on values whose 32-bit limbs all have their top bit set
    (a negative int32), against the JAX package's 16-bit-limb shifts."""
    rf = ref_get_field(RBN254.fr.p, "bn254.fr")
    vals = [v | sum(1 << (32 * k + 31) for k in range(8)) for v in rand_ints(1 << 256, 6, s)]
    ref = jnp.stack([jnp.asarray(rf._int_to_limbs_np(v)) for v in vals], axis=1)
    x = to_port(np.asarray(ref))
    assert bool((x < 0).all())
    assert same(shl_bits(x, s), ref_shl(ref, s))
    assert same(shr_bits(x, s), ref_shr(ref, s))
    m = (1 << 256) - 1
    assert [int(v) for v in get_field(RBN254.fr.p, "bn254.fr", device="cpu").from_limbs(
        shr_bits(x, s))] == [v >> s for v in vals]
    assert [v << s & m for v in vals] == [int(v) for v in limbs_np_to_ints(
        shl_bits(x, s).numpy().view(np.uint32))]
