"""The Shamir slice against the JAX package, every seed pinned, tolerance 0:
the share/combine, mul/open/inv/rand and EC open cases of
tests/test_shamir.py through both packages, the REP3 -> Shamir bridge, and
a 3-party (t = 1) co-Groth16 proof equal point for point to the
reference's and accepted by both verifiers.

The long proof comes first: `--dist loadfile` hands a worker its next file
when two tests of its current one are left.
"""

import random
import threading

import cocircom_tpu.mpc.rep3 as ref_rep3
import cocircom_tpu.utils.chacha as ref_chacha
import cocircom_tpu_torch.mpc.rep3 as port_rep3
import cocircom_tpu_torch.utils.chacha as port_chacha
import jax
import jax.numpy as jnp
import torch
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.io.r1cs import R1CS as RefR1CS
from cocircom_tpu.io.witness import Witness as RefWitness
from cocircom_tpu.io.zkey import read_groth16_zkey as ref_read_zkey
from cocircom_tpu.mpc.bridges import translate_rep3_to_shamir as ref_translate
from cocircom_tpu.mpc.runner import run_parties as ref_run_parties
from cocircom_tpu.mpc.shamir import ShamirDriver as RefShamirDriver
from cocircom_tpu.mpc.shamir import combine_field_shares_shamir as ref_combine
from cocircom_tpu.mpc.shamir import share_field_vec_shamir as ref_share
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.snark.groth16 import CoGroth16 as RefCoGroth16
from cocircom_tpu.snark.groth16_verify import verify_groth16 as ref_verify
from cocircom_tpu.snark.setup import groth16_setup as ref_setup
from cocircom_tpu.snark.shared import split_witness_shamir as ref_split_shamir
from cocircom_tpu_torch.fields.ec_host import ec_mul
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.io.witness import Witness
from cocircom_tpu_torch.io.zkey import read_groth16_zkey
from cocircom_tpu_torch.mpc.bridges import translate_rep3_to_shamir
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.mpc.shamir import (ShamirDriver, combine_field_shares_shamir,
                                           share_field_vec_shamir)
from cocircom_tpu_torch.ops.curve import pmap
from cocircom_tpu_torch.ops.field import get_field, ints_to_limbs_np
from cocircom_tpu_torch.pairing.tower import Tower
from cocircom_tpu_torch.snark.groth16 import CoGroth16
from cocircom_tpu_torch.snark.groth16_verify import verify_groth16
from cocircom_tpu_torch.snark.shared import split_witness_shamir
from torch_port_util import multiplier_chain, same, small_msm_engines

RFR = ref_get_field(BN254.fr.p, "bn254.fr")
FR = get_field(PBN254.fr.p, "bn254.fr", "cpu")
SEEDS = [bytes([0x30 + i]) * 32 for i in range(3)]


def _pinned_seed():
    return SEEDS[int(threading.current_thread().name.split("-")[-1])]


def _pin(monkeypatch):
    """Every party's fresh seeds, in both packages.  The Shamir driver and
    the bridge import `fresh_seed` inside the function, so they are pinned
    on utils.chacha; the REP3 driver imports it at the top of its module."""
    for mod in (ref_chacha, port_chacha, ref_rep3, port_rep3):
        monkeypatch.setattr(mod, "fresh_seed", _pinned_seed)


def _both(fn_port, fn_ref):
    """Run a 3-party function in each package, its threads named party-i."""
    def named(fn):
        def wrapped(i, net):
            threading.current_thread().name = f"party-{i}"
            return fn(i, net)
        return wrapped

    return run_parties(named(fn_port), 3), ref_run_parties(named(fn_ref), 3)


def test_shamir_groth16_proof_equals_reference_and_verifies(monkeypatch):
    restore = small_msm_engines(monkeypatch)
    try:
        _pin(monkeypatch)
        r1cs, vals = multiplier_chain(BN254, RefR1CS, 12, 5)
        zkey_bytes, vk = ref_setup(r1cs, seed=b"torch-port-shamir")
        publics = [vals[1], vals[2]]
        zk = read_groth16_zkey(zkey_bytes, device="cpu")
        shares = split_witness_shamir(Witness(PBN254, len(vals), ints_to_limbs_np(vals, 8)), 2,
                                      1, 3, seed=77, device="cpu")
        rzk = ref_read_zkey(zkey_bytes)
        rshares = ref_split_shamir(RefWitness(BN254, len(vals), RFR.to_limbs(vals)), 2, 1, 3,
                                   seed=77)
        for s, rs in zip(shares, rshares):
            assert same(s.witness, rs.witness)

        proofs, ref_proofs = _both(
            lambda i, net: CoGroth16(ShamirDriver(PBN254, net, 1, device="cpu")).prove(
                zk, shares[i]),
            lambda i, net: RefCoGroth16(RefShamirDriver(BN254, net, 1)).prove(rzk, rshares[i]))
        assert proofs[0] == proofs[1] == proofs[2]
        for k in ("pi_a", "pi_b", "pi_c"):
            assert proofs[0][k] == ref_proofs[0][k]
        pvk = dict(vk, curve=PBN254)
        assert verify_groth16(pvk, proofs[0], publics)
        assert not verify_groth16(pvk, proofs[0], [publics[0] + 1, publics[1]])
        assert ref_verify(vk, {**proofs[0], "curve": BN254}, publics)
    finally:
        restore()


def test_share_combine_roundtrip():
    rng = random.Random(41)
    vals = [rng.randrange(FR.p) for _ in range(5)]
    shares = share_field_vec_shamir(FR, FR.encode(vals), threshold=1, n_parties=3, seed=1,
                                    device="cpu")
    rshares = ref_share(RFR, RFR.encode(vals), threshold=1, n_parties=3, seed=1)
    for s, rs in zip(shares, rshares):
        assert same(s, rs)
    back = combine_field_shares_shamir(FR, shares, threshold=1)
    assert same(back, ref_combine(RFR, rshares, threshold=1))
    assert list(FR.decode(back)) == vals


def test_shamir_mul_open_inv_rand(monkeypatch):
    _pin(monkeypatch)
    rng = random.Random(42)
    n = 7
    x = [rng.randrange(FR.p) for _ in range(n)]
    y = [rng.randrange(FR.p) for _ in range(n)]
    xs = share_field_vec_shamir(FR, FR.encode(x), 1, 3, seed=2, device="cpu")
    ys = share_field_vec_shamir(FR, FR.encode(y), 1, 3, seed=3, device="cpu")
    rxs = ref_share(RFR, RFR.encode(x), 1, 3, seed=2)
    rys = ref_share(RFR, RFR.encode(y), 1, 3, seed=3)

    def run(d, xs, ys):
        z = d.mul_vec(xs, ys)
        inv = d.inv_many(xs)
        r = d.rand((3,))
        return (z, d.open_many(z), d.open_many(d.add(xs, ys)), inv, d.open_many(inv), r,
                d.open_many(r))

    port, ref = _both(
        lambda i, net: run(ShamirDriver(PBN254, net, 1, device="cpu"), xs[i], ys[i]),
        lambda i, net: run(RefShamirDriver(BN254, net, 1), rxs[i], rys[i]))
    want = ([a * b % FR.p for a, b in zip(x, y)], [(a + b) % FR.p for a, b in zip(x, y)],
            [pow(a, -1, FR.p) for a in x])
    for res, rres in zip(port, ref):
        for got, rgot in zip(res, rres):
            assert same(got, rgot)
        assert (list(FR.decode(res[1])), list(FR.decode(res[2])), list(FR.decode(res[4]))) \
            == want
    assert torch.equal(port[0][6], port[1][6]) and torch.equal(port[1][6], port[2][6])


def test_shamir_ec_open_and_rep3_bridge(monkeypatch):
    _pin(monkeypatch)
    rng = random.Random(43)
    s = rng.randrange(FR.p)
    ss = share_field_vec_shamir(FR, FR.encode([s]), 1, 3, seed=5, device="cpu")
    rss = ref_share(RFR, RFR.encode([s]), 1, 3, seed=5)
    vals = [rng.randrange(FR.p) for _ in range(6)]
    r3 = port_rep3.share_field_vec(FR, FR.encode(vals), seed=6)
    rr3 = ref_rep3.share_field_vec(RFR, RFR.encode(vals), seed=6)

    def port_party(i, net):
        d = ShamirDriver(PBN254, net, 1, device="cpu")
        gen = pmap(lambda c: c[..., 0], d.host_g1(PBN254.g1_gen))
        p1 = d.open_point(d.g1, d.scalar_mul_public_point(d.g1, gen, ss[i][:, 0]))
        tr = translate_rep3_to_shamir(PBN254, net, r3[i], 1)
        return d.g1.decode_points(pmap(lambda c: c[:, None], p1))[0], tr, d.open_many(tr)

    def ref_party(i, net):
        d = RefShamirDriver(BN254, net, 1)
        gen = jax.tree.map(lambda c: c[..., 0], d.host_g1(BN254.g1_gen))
        p1 = d.open_point(d.g1, d.scalar_mul_public_point(d.g1, gen, rss[i][:, 0]))
        tr = ref_translate(BN254, net, rr3[i], 1)
        return d.g1.decode_points(jax.tree.map(lambda c: jnp.expand_dims(c, 1), p1))[0], tr

    port, ref = _both(port_party, ref_party)
    t = Tower(PBN254)
    g = ec_mul((t.fp(PBN254.g1_gen[0]), t.fp(PBN254.g1_gen[1])), s)
    for (pt, tr, opened), (rpt, rtr) in zip(port, ref):
        assert pt == rpt == (g[0].v, g[1].v)
        assert same(tr, rtr)
        assert list(FR.decode(opened)) == vals
