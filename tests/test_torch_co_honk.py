"""Port vs JAX package: co-UltraHonk (honk/co_prover.py, co_alg.py,
co_builder.py) under REP3 and Shamir, and the noir CLI (noir/cli.py).

The oracle is the JAX package's PLAIN UltraHonk prover (honk/prover.py) on
the same circuit, witness and TestCrs: the co-prover's proof must equal it
byte for byte (tolerance 0) and verify.  The JAX co-prover is not run here:
it costs minutes on the CPU even at 16 gates.  For the ROM/RAM circuit the
builder runs in provider mode (co_builder.MpcBuilderValues: oblivious LUT
reads and writes, oblivious sorts); the JAX oracle is its plain prover over
the JAX package's provider-mode circuit, with the shared values filled in
on the host (`_reference_provider_proof`).

The CLI runs in process (`main([...])`, `--device cpu`), its parties as
threads over the in-process network.  Long tests first.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

from cocircom_tpu.fields.params import BN254 as RBN254
from cocircom_tpu.honk import prover as ref_prover
from cocircom_tpu.honk.builder import UltraCircuitBuilder as RefBuilder
from cocircom_tpu.honk.builder import acir_to_format as ref_acir_to_format
from cocircom_tpu.honk.co_builder import MpcBuilderValues as RefMpcValues
from cocircom_tpu.honk.crs import TestCrs as RefCrs
from cocircom_tpu.honk.proving_key import create_keys as ref_create_keys
from cocircom_tpu.mpc import codec as ref_codec
from cocircom_tpu.mpc.driver import plain_driver as ref_plain_driver
from cocircom_tpu.noir.acir import load_program_json as ref_load
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu_torch.fields.params import BN254
from cocircom_tpu_torch.honk import verifier
from cocircom_tpu_torch.honk.builder import P, UltraCircuitBuilder, acir_to_format
from cocircom_tpu_torch.honk.co_builder import MpcBuilderValues
from cocircom_tpu_torch.honk.co_prover import CoUltraHonk
from cocircom_tpu_torch.honk.crs import TestCrs
from cocircom_tpu_torch.honk.proving_key import create_keys
from cocircom_tpu_torch.mpc.rep3 import Rep3Driver, combine_field_shares, share_field_vec
from cocircom_tpu_torch.mpc.runner import _TurnNetwork, run_parties
from cocircom_tpu_torch.mpc.shamir import (ShamirDriver, combine_field_shares_shamir,
                                           share_field_vec_shamir)
from cocircom_tpu_torch.noir import cli
from cocircom_tpu_torch.noir.acir import write_witness_stack
from cocircom_tpu_torch.ops.field import get_field
from torch_port_util import acir_program_json, memory_circuit, squaring_chain

FR = get_field(P, "bn254.fr", device="cpu")


def _ref_circuit(c, abi):
    (rc,), _ = ref_load(acir_program_json(c, abi))
    return rc


def _reference_plain_proof(c, abi, w):
    """The JAX package's plain UltraHonk proof and vk of a circuit."""
    b = RefBuilder(ref_acir_to_format(_ref_circuit(c, abi)), w)
    pk, vk = ref_create_keys(b, RefCrs())
    return ref_prover.prove(pk), vk


def _reference_provider_proof(c, abi, w):
    """The JAX package's plain UltraHonk prover over its provider-mode
    circuit (the oblivious ROM/RAM structure a co-prover proves): the
    builder runs with the JAX plain driver, is finalized, and every shared
    value (the witness, the registered extras, the sorted RAM rows' access
    types, which the co-prover adds into w_4 at their rows) is filled in on
    the host before the keys are made."""
    rf = ref_get_field(RBN254.fr.p, "bn254.fr")
    dp = ref_plain_driver(RBN254)
    m = RefMpcValues(dp, dp.promote_public(rf.to_mont(jnp.asarray(rf.to_limbs(w)))))
    af = ref_acir_to_format(_ref_circuit(c, abi))
    b = RefBuilder(af, [0] * af.varnum, mpc=m)
    b.add_gates_to_ensure_all_polys_are_non_zero()
    b.finalize_circuit()

    def dec(h):
        return int(rf.from_limbs(rf.from_mont(h))[0])

    for i in range(af.varnum):
        b.variables[i] = w[i] % P
    for i, h in m.extra.items():
        b.variables[i] = dec(h)
    pk, vk = ref_create_keys(b, RefCrs())
    for r, h in zip(pk.memory_mixed_records, m.mixed_access):
        pk.witness[3][r] = (pk.witness[3][r] + dec(h)) % P
    pk.memory_read_records = list(pk.memory_read_records) + list(pk.memory_mixed_records)
    return ref_prover.prove(pk), vk


@pytest.fixture(scope="module")
def chain():
    """The 16-gate squaring chain of the Shamir and CLI proofs: (circuit,
    abi, witness, the JAX package's plain proof), made once for the file."""
    c, abi, w, _inputs = squaring_chain(16, 53)
    want, _rvk = _reference_plain_proof(c, abi, w)
    return c, abi, w, want


def test_rep3_memory_circuit_proof_equals_reference(monkeypatch):
    """ROM read and RAM write and read at shared indices, proved by three
    REP3 parties in provider mode: the proof equals the JAX package's plain
    proof of the same provider-mode circuit and verifies under the vk of a
    structure-only (zero-valued) builder; a changed public input is
    refused.  The sumcheck runs in chunks of 16 edges, so round 0 is two
    chunks and relation families whose selector is zero on a chunk are
    skipped there (at the default chunk size a circuit this small is one
    chunk)."""
    import cocircom_tpu_torch.honk.co_prover as co_prover

    monkeypatch.setattr(co_prover, "EDGE_CHUNK", 16)
    c, abi, w, _inputs = memory_circuit(51)
    want, _rvk = _reference_provider_proof(c, abi, w)
    shares = share_field_vec(FR, FR.encode(w), seed=52)

    def party(i, net):
        d = Rep3Driver(BN254, net, device="cpu")
        b = UltraCircuitBuilder(acir_to_format(c), [0] * len(w),
                                mpc=MpcBuilderValues(d, shares[i]))
        return CoUltraHonk(d, TestCrs()).prove(b, shares[i])

    proofs = run_parties(party, 3)
    assert proofs[0] == proofs[1] == proofs[2] == want
    from cocircom_tpu_torch.mpc.driver import PlainDriver

    dp = PlainDriver(BN254, device="cpu")
    zero = UltraCircuitBuilder(acir_to_format(c), [0] * len(w),
                               mpc=MpcBuilderValues(dp, dp.promote_public(FR.zeros((len(w),)))))
    _pk, vk = create_keys(zero, TestCrs())
    assert verifier.verify(proofs[0], vk)
    changed = list(proofs[0])
    changed[3] = (changed[3] + 1) % P
    assert not verifier.verify(changed, vk)


def test_shamir_chain_proof_equals_reference(chain):
    """Shamir (n = 3, t = 1) parties prove the 16-gate squaring chain: the
    proof equals the JAX package's plain proof and verifies."""
    c, _abi, w, want = chain
    shares = share_field_vec_shamir(FR, FR.encode(w), 1, 3, seed=54, device="cpu")

    def party(i, net):
        d = ShamirDriver(BN254, net, threshold=1, device="cpu")
        b = UltraCircuitBuilder(acir_to_format(c), [0] * len(w))
        return CoUltraHonk(d, TestCrs()).prove(b, shares[i])

    proofs = run_parties(party, 3)
    assert proofs[0] == proofs[1] == proofs[2] == want
    _pk, vk = create_keys(UltraCircuitBuilder(acir_to_format(c), w), TestCrs())
    assert verifier.verify(proofs[0], vk)


def _run_cli(argv) -> tuple:
    """cli.main(argv) -> (exit code, SystemExit message)."""
    try:
        cli.main(list(argv))
    except SystemExit as e:
        return (e.code, "") if isinstance(e.code, int) else (1, str(e.code))
    return 0, ""


class _PartyNet(_TurnNetwork):
    """A party's in-process network with the `close` the CLI calls."""

    def close(self):
        pass


def _parties(monkeypatch, argv_of):
    """Three CLI party threads (run_parties: the in-process network, the
    parties taking turns), each calling main(argv_of(i)) with --net-config
    naming nothing: the CLI's mesh constructor is replaced by the party's
    network.  The TCP/TLS mesh itself is held by tests/test_torch_cli.py,
    tests/test_torch_tcp_net.py and chip_smoke.py's noir_cli phase."""
    mine = threading.local()
    monkeypatch.setattr(cli, "_network", lambda net_config, device: mine.net)

    def party(i, net):
        mine.net = _PartyNet(net._inner, net._turn)
        code, msg = _run_cli(["--device", "cpu"] + argv_of(i, "in-process"))
        assert code == 0, msg

    run_parties(party, 3)


def _file_share(path):
    """A .shared file through the JAX package's codec: its kind and the
    port's (a, b) or Shamir tensors."""
    from cocircom_tpu_torch.io.shares_io import _from_file

    obj = ref_codec.decode(path.read_bytes())
    comps = [_from_file(np.asarray(obj[k]), "cpu") for k in ("a", "b") if k in obj]
    return obj["kind"], comps


def test_noir_cli_pipeline(chain, tmp_path, capsys, monkeypatch):
    """Every subcommand in process: split-input from two providers' ABIs,
    merge-input-shares, the REP3 co-ACVM (generate-witness) over a TCP mesh
    on the ROM/RAM circuit, translate-witness to Shamir; then on the
    squaring chain split-witness, three generate-proof parties, create-vk
    and verify.  The files read through the JAX package's codec open to the
    witness; the proof equals the JAX package's plain proof; verify refuses
    it with a changed public input."""
    d = str(tmp_path)
    c, abi, w, inputs = memory_circuit(55)
    names = [p["name"] for p in abi["parameters"]]
    for k, part in enumerate((names[:2], names[2:])):
        sub = {"parameters": [p for p in abi["parameters"] if p["name"] in part]}
        (tmp_path / f"mem{k}.json").write_text(acir_program_json(c, sub))
        (tmp_path / f"p{k}.toml").write_text("".join(
            f'{nm} = "{hex(inputs[names.index(nm)])}"\n' for nm in part))
        assert _run_cli(["--device", "cpu", "split-input", "--input", f"{d}/p{k}.toml",
                         "--circuit", f"{d}/mem{k}.json", "--out-dir", f"{d}/in{k}"]) == (0, "")
    (tmp_path / "mem.json").write_text(acir_program_json(c, abi))
    for i in range(3):
        assert _run_cli(["merge-input-shares", f"{d}/in0/p0.toml.{i}.shared",
                         f"{d}/in1/p1.toml.{i}.shared", "--out", f"{d}/merged.{i}.shared"]) == (0, "")
    merged = [_file_share(tmp_path / f"merged.{i}.shared")[1] for i in range(3)]
    from cocircom_tpu_torch.mpc.rep3 import Rep3FieldShare

    opened = combine_field_shares(FR, [Rep3FieldShare(*m) for m in merged])
    assert [int(v) for v in FR.decode(opened)] == inputs

    _parties(monkeypatch, lambda i, net: [
        "generate-witness", "--input", f"{d}/merged.{i}.shared", "--circuit", f"{d}/mem.json",
        "--net-config", net, "--out", f"{d}/wit.{i}.shared"])
    wits = [_file_share(tmp_path / f"wit.{i}.shared") for i in range(3)]
    assert all(kind == "noir-witness" for kind, _ in wits)
    opened = combine_field_shares(FR, [Rep3FieldShare(*comps) for _, comps in wits])
    assert [int(v) for v in FR.decode(opened)] == w

    _parties(monkeypatch, lambda i, net: [
        "translate-witness", "--witness", f"{d}/wit.{i}.shared", "--net-config", net,
        "--out", f"{d}/sh.{i}.shared"])
    sh = [_file_share(tmp_path / f"sh.{i}.shared") for i in range(3)]
    assert all(kind == "noir-witness-shamir" for kind, _ in sh)
    opened = combine_field_shares_shamir(FR, [comps[0] for _, comps in sh], 1)
    assert [int(v) for v in FR.decode(opened)] == w

    c, abi, w, want = chain
    (tmp_path / "chain.json").write_text(acir_program_json(c, abi))
    (tmp_path / "chain.gz").write_bytes(write_witness_stack([(0, dict(enumerate(w)))]))
    assert _run_cli(["--device", "cpu", "split-witness", "--witness", f"{d}/chain.gz",
                     "--circuit", f"{d}/chain.json", "--out-dir", f"{d}/sw"]) == (0, "")
    _parties(monkeypatch, lambda i, net: [
        "generate-proof", "--witness", f"{d}/sw/witness.gz.{i}.shared",
        "--circuit", f"{d}/chain.json", "--net-config", net, "--out", f"{d}/proof.{i}"])
    proofs = [(tmp_path / f"proof.{i}").read_bytes() for i in range(3)]
    assert proofs[0] == proofs[1] == proofs[2] == ref_prover.proof_to_buffer(want)
    assert _run_cli(["--device", "cpu", "create-vk", "--circuit", f"{d}/chain.json", "--out", f"{d}/vk.json"]) \
        == (0, "")
    capsys.readouterr()
    assert _run_cli(["verify", "--proof", f"{d}/proof.0", "--vk", f"{d}/vk.json"]) == (0, "")
    assert "verification: OK" in capsys.readouterr().out
    bad = bytearray(proofs[0])
    bad[4 + 3 * 32 + 31] ^= 1  # the first public input
    (tmp_path / "bad").write_bytes(bytes(bad))
    assert _run_cli(["verify", "--proof", f"{d}/bad", "--vk", f"{d}/vk.json"])[0] == 1
    assert "verification: FAILED" in capsys.readouterr().out


# ------------------------------------------------- the co-prover's pieces
# (short tests last in the file: see ROADMAP, "Test time")

def test_generator_table_equals_host_scalar_mul():
    """GeneratorTable (the commitments' products with the generator: one
    lookup a four-bit window and a tree sum) gives the host's s * G, for 0,
    1, p - 1 and random scalars."""
    import random

    from cocircom_tpu_torch.fields.ec_host import ec_mul
    from cocircom_tpu_torch.honk.co_prover import GeneratorTable
    from cocircom_tpu_torch.ops.curve import g1_ops

    crs = TestCrs()
    ops = g1_ops(BN254, "cpu")
    rng = random.Random(57)
    scalars = [0, 1, P - 1, 16, 2 ** 253 + 5] + [rng.randrange(P) for _ in range(3)]
    got = ops.decode_points(GeneratorTable(ops, crs.g1).mul(FR.to_limbs(scalars)))
    for s, pt in zip(scalars, got):
        want = ec_mul(crs.g1, s)
        assert pt == (None if want is None else (want[0].v, want[1].v))


def test_co_alg_broadcasts_and_matches_integers():
    """Pub and Sh over the plain driver: (L, 8, E) edge tensors against
    (L, E) and (L,) operands and int literals, every operator, held to
    Python integers mod p; `% P` is the identity."""
    from cocircom_tpu_torch.honk.co_alg import CoAlg
    from cocircom_tpu_torch.mpc.driver import PlainDriver

    d = PlainDriver(BN254, device="cpu")
    alg = CoAlg(d)
    rng = np.random.default_rng(58)
    a = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(3)] for _ in range(8)]
    b = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(3)]
    x = alg.sh(FR.encode(a))                # (L, 8, 3)
    y = alg.pub(FR.encode(b))               # (L, 3)
    z = alg.pub_of_int(7)                   # (L,)
    got = ((x * y + z) * x - y * 5 + (3 - x) * (-x)) % P
    want = [[((ai * bi + 7) * ai - bi * 5 + (3 - ai) * (-ai)) % P for ai, bi in zip(row, b)]
            for row in a]
    assert [[int(v) for v in r] for r in FR.decode(got.v)] == want
    assert alg.mul_elems == 2 * 8 * 3  # two shared x shared products of (8, 3)


def test_wire_index_maps_gather_the_proving_key_wires():
    """The co-prover gathers the four wire columns by index
    (wire_index_maps); on the builder's values those indices give the
    plain proving key's wire polynomials."""
    from cocircom_tpu_torch.honk.co_prover import wire_index_maps
    from cocircom_tpu_torch.honk.proving_key import create_proving_key

    c, _abi, w, _ = memory_circuit(59)
    b = UltraCircuitBuilder(acir_to_format(c), w)
    pk = create_proving_key(b, TestCrs())
    vals = b.variables + [0]
    for k, idx in enumerate(wire_index_maps(b, pk.circuit_size)):
        assert [vals[i] for i in idx] == pk.witness[k]


def test_bitonic_network_sorts():
    """The oblivious sort's network (co_builder._bitonic_stages) as
    compare-exchanges sorts every list it is given, at 2..32 records."""
    from cocircom_tpu_torch.honk.co_builder import _bitonic_stages

    rng = np.random.default_rng(60)
    for n in (2, 4, 8, 16, 32):
        for _ in range(5):
            keys = list(rng.permutation(4 * n)[:n])
            for lo, hi in _bitonic_stages(n):
                for i, j in zip(lo, hi):
                    if keys[i] > keys[j]:
                        keys[i], keys[j] = keys[j], keys[i]
            assert keys == sorted(keys)
