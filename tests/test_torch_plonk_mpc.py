"""co-PLONK under REP3 and Shamir in the port, against the JAX package's
Plain proof: with deterministic blinding an opened value does not depend on
how it was shared, so the 3-party REP3 and Shamir (t = 1) proofs must be
byte-equal, as JSON, to the reference's one Plain proof of the same witness
(computed once for the file).  One more REP3 proof with random blinding must
verify, with its five round spans.

The fixture is `test_torch_plonk.py`'s.  The long proofs come first:
`--dist loadfile` hands a worker its next file when two tests of its
current one are left.
"""

import functools

import cocircom_tpu.mpc.rep3 as ref_rep3
import cocircom_tpu.utils.chacha as ref_chacha
import cocircom_tpu_torch.mpc.rep3 as port_rep3
import cocircom_tpu_torch.utils.chacha as port_chacha
import pytest
import torch
from cocircom_tpu.fields.params import BN254
from cocircom_tpu.io.jsonio import dump_plonk_proof as ref_dump
from cocircom_tpu.io.plonk_zkey import read_plonk_zkey as ref_read
from cocircom_tpu.io.r1cs import R1CS as RefR1CS
from cocircom_tpu.mpc.driver import PlainDriver as RefPlainDriver
from cocircom_tpu.mpc.runner import run_parties as ref_run_parties
from cocircom_tpu.mpc.shamir import ShamirDriver as RefShamirDriver
from cocircom_tpu.mpc.shamir import share_field_vec_shamir as ref_share_shamir
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.snark.plonk import CoPlonk as RefCoPlonk
from cocircom_tpu.snark.plonk_setup import plonk_setup as ref_setup
from cocircom_tpu.snark.plonk_verify import verify_plonk as ref_verify
from cocircom_tpu.snark.shared import SharedWitness as RefSharedWitness
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.io.jsonio import dump_plonk_proof
from cocircom_tpu_torch.io.plonk_zkey import read_plonk_zkey
from cocircom_tpu_torch.io.witness import Witness
from cocircom_tpu_torch.mpc.rep3 import Rep3Driver, share_field_vec
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.mpc.shamir import ShamirDriver, share_field_vec_shamir
from cocircom_tpu_torch.ops.curve import leaves
from cocircom_tpu_torch.ops.field import get_field, ints_to_limbs_np
from cocircom_tpu_torch.snark.plonk import ROUND_SPANS, CoPlonk
from cocircom_tpu_torch.snark.plonk_verify import verify_plonk
from cocircom_tpu_torch.snark.shared import split_witness_rep3, split_witness_shamir
from cocircom_tpu_torch.utils.trace import Tracer
from torch_port_util import plonk_chain, same, small_msm_engines

SEED = b"torch-port-plonk-mpc"


@functools.lru_cache(maxsize=None)
def _reference():
    """(zkey bytes, vk, witness values, the JAX package's Plain proof JSON
    with deterministic blinding)."""
    r1cs, vals = plonk_chain(BN254, RefR1CS, 12, 5)
    zkey_bytes, vk = ref_setup(r1cs, seed=SEED)
    rd = RefPlainDriver(BN254)
    shared = RefSharedWitness(vals[:3], rd.fr.encode(vals[3:]))
    proof = RefCoPlonk(rd, deterministic_blinding=True).prove(ref_read(zkey_bytes), shared)
    assert ref_verify(vk, proof, vals[1:3])
    return zkey_bytes, vk, vals, ref_dump(BN254, proof)


@pytest.fixture
def plonk_env(monkeypatch):
    monkeypatch.setenv("COCIRCOM_INSECURE_DETERMINISTIC", "1")
    restore = small_msm_engines(monkeypatch)
    try:
        zkey_bytes, vk, vals, ref_json = _reference()
        yield read_plonk_zkey(zkey_bytes, device="cpu"), dict(vk, curve=PBN254), vals, ref_json
    finally:
        restore()


def _witness(vals):
    return Witness(PBN254, len(vals), ints_to_limbs_np(vals, 8))


def _prove(make_driver, zk, shares, deterministic=True, tracer=None):
    def party(i, net):
        return CoPlonk(make_driver(net), deterministic,
                       tracer if i == 0 else None).prove(zk, shares[i])

    proofs = run_parties(party, 3)
    assert proofs[0] == proofs[1] == proofs[2]
    return proofs[0]


def test_rep3_deterministic_proof_equals_reference(plonk_env):
    zk, vk, vals, ref_json = plonk_env
    shares = split_witness_rep3(_witness(vals), 2, seed=11, device="cpu")
    proof = _prove(lambda net: Rep3Driver(PBN254, net, device="cpu"), zk, shares)
    assert dump_plonk_proof(PBN254, proof) == ref_json
    assert verify_plonk(vk, proof, vals[1:3])


def test_shamir_deterministic_proof_equals_reference(plonk_env):
    zk, vk, vals, ref_json = plonk_env
    shares = split_witness_shamir(_witness(vals), 2, 1, 3, seed=12, device="cpu")
    proof = _prove(lambda net: ShamirDriver(PBN254, net, 1, device="cpu"), zk, shares)
    assert dump_plonk_proof(PBN254, proof) == ref_json
    assert verify_plonk(vk, proof, vals[1:3])
    assert ref_verify({**vk, "curve": BN254}, {**proof, "curve": BN254}, vals[1:3])


def test_rep3_random_blinding_proof_verifies(plonk_env):
    zk, vk, vals, ref_json = plonk_env
    shares = split_witness_rep3(_witness(vals), 2, seed=13, device="cpu")
    tracer = Tracer(enabled=True)
    proof = _prove(lambda net: Rep3Driver(PBN254, net, device="cpu"), zk, shares,
                   deterministic=False, tracer=tracer)
    assert [r[1] for r in tracer.rows] == list(ROUND_SPANS)
    assert dump_plonk_proof(PBN254, proof) != ref_json
    assert verify_plonk(vk, proof, vals[1:3])
    assert not verify_plonk(vk, proof, [vals[1], vals[2] + 1])


@pytest.mark.parametrize("protocol", ["rep3", "shamir"])
def test_long_vectors_in_pieces_equal_whole(protocol, monkeypatch):
    """A product round over a vector longer than a draw's piece (made a
    piece at a time: the mask draws, the carry chains, the Shamir pairs)
    gives the shares it gives in one piece, and the shares the JAX
    package's driver gives, seeds pinned."""
    fr = get_field(PBN254.fr.p, "bn254.fr", "cpu")
    rfr = ref_get_field(BN254.fr.p, "bn254.fr")
    ints = list(range(3, 3 + 37))
    vals, rvals = fr.encode(ints), rfr.encode(ints)
    for mod in (port_chacha, port_rep3, ref_chacha, ref_rep3):
        monkeypatch.setattr(mod, "fresh_seed", lambda: bytes(32))
    if protocol == "rep3":
        shares = share_field_vec(fr, vals, seed=16)
        rshares = ref_rep3.share_field_vec(rfr, rvals, seed=16)
        make = lambda net: Rep3Driver(PBN254, net, device="cpu")  # noqa: E731
        rmake = lambda net: ref_rep3.Rep3Driver(BN254, net)  # noqa: E731
    else:
        shares = share_field_vec_shamir(fr, vals, 1, 3, seed=16, device="cpu")
        rshares = ref_share_shamir(rfr, rvals, 1, 3, seed=16)
        make = lambda net: ShamirDriver(PBN254, net, 1, device="cpu")  # noqa: E731
        rmake = lambda net: RefShamirDriver(BN254, net, 1)  # noqa: E731

    def run():
        return run_parties(lambda i, net: make(net).mul_vec(shares[i], shares[i]), 3)

    whole = run()
    ref = ref_run_parties(lambda i, net: rmake(net).mul_vec(rshares[i], rshares[i]), 3)
    monkeypatch.setattr(port_chacha.ChaChaStream, "PIECE", 64)
    monkeypatch.setattr(type(fr), "PIECE", 5)
    pieces = run()
    for w, p, r in zip(whole, pieces, ref):
        for a, b, c in zip(leaves(w), leaves(p), r if protocol == "rep3" else [r]):
            assert torch.equal(a, b)
            assert same(b, c)


@pytest.mark.parametrize("protocol", ["rep3", "shamir"])
def test_inv_many_aborts_on_a_zero_share(protocol):
    fr = get_field(PBN254.fr.p, "bn254.fr", "cpu")
    x = fr.encode([3, 0, 5])
    if protocol == "rep3":
        shares = share_field_vec(fr, x, seed=14)
        make = lambda net: Rep3Driver(PBN254, net, device="cpu")  # noqa: E731
    else:
        shares = share_field_vec_shamir(fr, x, 1, 3, seed=14, device="cpu")
        make = lambda net: ShamirDriver(PBN254, net, 1, device="cpu")  # noqa: E731
    with pytest.raises(ZeroDivisionError):
        run_parties(lambda i, net: make(net).inv_many(shares[i]), 3)
    ok = fr.encode([3, 7, 5])
    shares = share_field_vec(fr, ok, seed=15) if protocol == "rep3" else \
        share_field_vec_shamir(fr, ok, 1, 3, seed=15, device="cpu")
    outs = run_parties(lambda i, net: (lambda d: d.open_many(d.inv_many(shares[i])))(make(net)), 3)
    inv = [pow(v, -1, fr.p) for v in (3, 7, 5)]
    assert all(list(fr.decode(o)) == inv for o in outs)
    assert torch.equal(outs[0], outs[1])
