"""Port vs JAX package: the command line (cli.py), the .shared files
(io/shares_io.py) and the layout fit (vm/fit_layout.py).

The CLI runs in process (`cli.main([...])`, `--device cpu`) on
chip_smoke.py's SplitChain at a few constraints, its .r1cs written by
chip_smoke.write_r1cs.  Here on the CPU it proves only with `plain` (a REP3
proof costs minutes on the CPU's plain versions); the REP3, Shamir and PLONK
proofs through the CLI, as party processes on the card, are chip_smoke.py's
`cli` phase.  Tolerance 0 throughout.
"""

import json
import threading

import numpy as np
import pytest
import torch

import cocircom_tpu.io.shares_io as ref_io
from chip_smoke import (CLI_CHAIN_SRC, CLI_SPANS, cli_chain, free_ports, parse_report,
                        write_r1cs)
from cocircom_tpu import cli as ref_cli
from cocircom_tpu.fields.params import curve_by_name as ref_curve_by_name
from cocircom_tpu.mpc.rep3 import Rep3FieldShare as RefRep3FieldShare
from cocircom_tpu.snark.groth16 import SharedWitness as RefSharedWitness
from cocircom_tpu.snark.shared import SharedInput as RefSharedInput
from cocircom_tpu.vm.fit_layout import fit_keep_labels as ref_fit_keep_labels
from cocircom_tpu_torch import cli, convert
from cocircom_tpu_torch.fields.params import BLS12_381, BN254
from cocircom_tpu_torch.io import shares_io
from cocircom_tpu_torch.mpc.driver import PlainDriver
from cocircom_tpu_torch.mpc.rep3 import Rep3FieldShare, combine_field_shares
from cocircom_tpu_torch.mpc.shamir import combine_field_shares_shamir
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.snark.groth16 import SharedWitness
from cocircom_tpu_torch.snark.shared import SharedInput
from cocircom_tpu_torch.vm.compiler import compile_circom
from cocircom_tpu_torch.vm.fit_layout import fit_keep_labels
from cocircom_tpu_torch.vm.mpc_vm import WitnessExtension
from torch_port_util import rand_ints, small_msm_engines

CONS = 4  # constraints of the CLI's chain: SplitChain(3)
INPUTS = {"a": 3, "b": 5, "c": 7}


def run_cli(capsys, *argv) -> tuple:
    """cli.main(argv): (exit code, what it printed; a SystemExit message is
    what the interpreter would print)."""
    code, msg = 0, ""
    try:
        cli.main(list(argv))
    except SystemExit as e:
        code, msg = (e.code, "") if isinstance(e.code, int) else (1, str(e.code))
    out = capsys.readouterr()
    return code, out.out + out.err + msg


def _fr(curve):
    return get_field(curve.fr.p, curve.name + ".fr", device="cpu")


def _ints(fr, limbs) -> list:
    return [int(v) for v in fr.from_limbs(fr.from_mont(limbs))]


def _chain_files(tmp_path):
    r1cs, vals = cli_chain(BN254, CONS, **INPUTS)
    (tmp_path / "chain.r1cs").write_bytes(write_r1cs(r1cs))
    (tmp_path / "chain.circom").write_text(CLI_CHAIN_SRC % (CONS - 1))
    return vals


def test_cli_plain_pipeline_proves_and_verifies(tmp_path, capsys, monkeypatch):
    """setup groth16 from the .r1cs; a plain generate-witness equal to the JAX
    CLI's .wtns bytes; split-witness plain, rep3 and shamir files that open
    to the witness; a plain proof that verify accepts and refuses with a
    changed public input."""
    restore = small_msm_engines(monkeypatch)
    try:
        vals = _chain_files(tmp_path)
        d = str(tmp_path)
        (tmp_path / "input.json").write_text(json.dumps(INPUTS))
        code, out = run_cli(capsys, "setup", "groth16", f"{d}/chain.r1cs", f"{d}/chain.zkey",
                            "--vk", f"{d}/vk.json", "--seed", "cli-test")
        assert code == 0 and f"{CONS} constraints" in out
        code, _ = run_cli(capsys, "--device", "cpu", "generate-witness", "--circuit",
                          f"{d}/chain.circom", "--input", f"{d}/input.json", "--out", f"{d}/w.wtns")
        assert code == 0
        ref_cli.main(["--device", "cpu", "generate-witness", "--circuit", f"{d}/chain.circom",
                      "--input", f"{d}/input.json", "--out", f"{d}/ref.wtns"])
        assert (tmp_path / "w.wtns").read_bytes() == (tmp_path / "ref.wtns").read_bytes()

        fr = _fr(BN254)
        for proto in ("plain", "rep3", "shamir"):
            code, _ = run_cli(capsys, "--device", "cpu", "split-witness", "--witness",
                              f"{d}/w.wtns", "--r1cs", f"{d}/chain.r1cs", "--protocol", proto,
                              "--out-dir", f"{d}/{proto}")
            assert code == 0
            n = 1 if proto == "plain" else 3
            opened = [shares_io.shared_witness_to_split(
                (tmp_path / proto / f"witness.wtns.{i}.shared").read_bytes(), device="cpu")
                for i in range(n)]
            assert all(o[0] == proto and o[1] is BN254 and o[2].public_inputs == vals[:3]
                       for o in opened)
            ws = [o[2].witness for o in opened]
            if proto == "rep3":
                aux = combine_field_shares(fr, ws)
            elif proto == "shamir":
                aux = combine_field_shares_shamir(fr, ws, 1)
            else:
                aux = ws[0]
            assert _ints(fr, aux) == vals[3:], proto

        monkeypatch.setenv("COCIRCOM_TRACE", "1")
        code, out = run_cli(capsys, "--device", "cpu", "generate-proof", "groth16", "--zkey",
                            f"{d}/chain.zkey", "--witness", f"{d}/plain/witness.wtns.0.shared",
                            "--out", f"{d}/proof.json", "--public-out", f"{d}/public.json")
        monkeypatch.delenv("COCIRCOM_TRACE")
        assert code == 0
        # the report: every span, the party's waits (none: a plain proof
        # receives nothing), then the set-up's and the proof's launch counts
        # apart (none on the CPU), and no device memory line
        spans, launches, peak, setup, waits = parse_report(out)
        assert all(k in spans for k in CLI_SPANS)
        assert waits == {"recv_wait_s": 0.0, "turn_wait_s": 0.0}
        assert launches == setup == {} and peak is None
        assert json.loads((tmp_path / "public.json").read_text()) == [str(v) for v in vals[1:3]]
        code, out = run_cli(capsys, "verify", "groth16", "--proof", f"{d}/proof.json", "--vk",
                            f"{d}/vk.json", "--public", f"{d}/public.json")
        assert code == 0 and "verification: OK" in out
        (tmp_path / "bad.json").write_text(json.dumps([str(vals[1]), str(vals[2] + 1)]))
        code, out = run_cli(capsys, "verify", "groth16", "--proof", f"{d}/proof.json", "--vk",
                            f"{d}/vk.json", "--public", f"{d}/bad.json")
        assert code == 1 and "verification: FAILED" in out
    finally:
        restore()


def test_cli_rep3_witness_extension_over_tls_mesh(tmp_path, capsys):
    """Two input providers split their inputs (split-input), each party
    merges its two files (merge-input-shares), three generate-witness
    --protocol rep3 threads meet over a mutual-TLS TcpNetwork mesh (certs
    from gen-cert), and the opened witness equals run_host's."""
    vals = _chain_files(tmp_path)
    d = str(tmp_path)
    providers = {"p1": {"a": 3, "b": 5}, "p2": {"a": 3, "c": 7}}
    for name, inputs in providers.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(inputs))
        code, _ = run_cli(capsys, "--device", "cpu", "split-input", "--input", f"{d}/{name}.json",
                          "--circuit", f"{d}/chain.circom", "--out-dir", f"{d}/{name}")
        assert code == 0
    for i in range(3):
        code, _ = run_cli(capsys, "--device", "cpu", "merge-input-shares",
                          f"{d}/p1/p1.json.{i}.shared", f"{d}/p2/p2.json.{i}.shared",
                          "--out", f"{d}/merged.{i}.shared")
        assert code == 0
        code, _ = run_cli(capsys, "gen-cert", "--key-out", f"{d}/key{i}.pem",
                          "--cert-out", f"{d}/cert{i}.pem")
        assert code == 0
    ports = free_ports(3)
    for i in range(3):
        (tmp_path / f"net{i}.json").write_text(json.dumps({
            "my_id": i, "key_path": f"{d}/key{i}.pem",
            "parties": [{"id": j, "host": "127.0.0.1", "port": ports[j],
                         "cert_path": f"{d}/cert{j}.pem"} for j in range(3)]}))
    errors = []

    def party(i):
        try:
            cli.main(["--device", "cpu", "generate-witness", "--protocol", "rep3", "--circuit",
                      f"{d}/chain.circom", "--input", f"{d}/merged.{i}.shared",
                      "--net-config", f"{d}/net{i}.json", "--out", f"{d}/sw.{i}.shared"])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=party, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    fr = _fr(BN254)
    sws = [shares_io.shared_witness_to_split((tmp_path / f"sw.{i}.shared").read_bytes(),
                                             device="cpu") for i in range(3)]
    assert all(s[0] == "rep3" and s[2].public_inputs == vals[:3] for s in sws)
    assert _ints(fr, combine_field_shares(fr, [s[2].witness for s in sws])) == vals[3:]
    circuit = compile_circom(CLI_CHAIN_SRC % (CONS - 1), BN254)
    assert WitnessExtension(PlainDriver(BN254, device="cpu"), circuit).run_host(INPUTS) == vals


def _random_tensor(curve, n, seed):
    fr = _fr(curve)
    return fr.encode(rand_ints(curve.fr.p, n, seed))


def _port_object(kind, curve, seed):
    t = [_random_tensor(curve, 6, seed + k) for k in range(4)]
    publics = [1, 11, 12]
    if kind == "input":
        return SharedInput({"pub": [5, 6]}, {"x": Rep3FieldShare(t[0], t[1]),
                                             "y": Rep3FieldShare(t[2][:, :2], t[3][:, :2])})
    if kind == "rep3":
        return SharedWitness(publics, Rep3FieldShare(t[0], t[1]))
    return SharedWitness(publics, t[0])


def _to_ref(obj):
    """The port's object -> the JAX package's, its arrays in 16-bit limbs."""
    conv = convert.field_to_reference
    if isinstance(obj, SharedInput):
        return RefSharedInput(obj.public_inputs, {
            k: RefRep3FieldShare(conv(v.a), conv(v.b)) for k, v in obj.shared_inputs.items()})
    w = obj.witness
    share = RefRep3FieldShare(conv(w.a), conv(w.b)) if isinstance(w, Rep3FieldShare) else conv(w)
    return RefSharedWitness(obj.public_inputs, share)


def _components(obj) -> list:
    """Every share array of a port or JAX object as numpy 16-bit limbs."""
    def arr(x):
        return convert.field_to_reference(x) if isinstance(x, torch.Tensor) else np.asarray(x)

    if hasattr(obj, "shared_inputs"):
        return [arr(c) for k in sorted(obj.shared_inputs) for c in obj.shared_inputs[k]]
    w = obj.witness
    return [arr(c) for c in w] if isinstance(w, tuple) else [arr(w)]


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("kind", ["plain", "rep3", "shamir", "input"])
def test_shared_files_are_read_by_the_other_package(kind, curve):
    """A file the port writes is read by the JAX package with equal share
    components, and the other way round (16-bit limbs in uint32 on disk)."""
    port_obj = _port_object(kind, curve, seed=500 + 10 * len(kind))
    ref_obj = _to_ref(port_obj)
    ref_curve = ref_curve_by_name(curve.name)
    if kind == "input":
        data = shares_io.write_shared_input("rep3", curve.name, port_obj)
        proto, c, got = ref_io.read_shared_input(data)
        assert got.public_inputs == port_obj.public_inputs
        ref_data = ref_io.write_shared_input("rep3", curve.name, ref_obj)
        proto2, c2, back = shares_io.read_shared_input(ref_data, device="cpu")
        assert back.public_inputs == port_obj.public_inputs
    else:
        data = shares_io.shared_witness_from_split(kind, curve, port_obj)
        proto, c, got = ref_io.shared_witness_to_split(data)
        assert got.public_inputs == port_obj.public_inputs
        ref_data = ref_io.shared_witness_from_split(kind, ref_curve, ref_obj)
        proto2, c2, back = shares_io.shared_witness_to_split(ref_data, device="cpu")
        assert back.public_inputs == port_obj.public_inputs
    assert proto == proto2 == ("rep3" if kind == "input" else kind)
    assert c.name == c2.name == curve.name
    want = _components(port_obj)
    for got_c, back_c, w in zip(_components(got), _components(back), want, strict=True):
        assert np.array_equal(got_c, w) and np.array_equal(back_c, w)
    # the JAX package's own file of the same object is byte-equal to the port's
    assert ref_data == data
    with pytest.raises(ValueError, match="not a shared"):
        (shares_io.read_shared_witness if kind == "input" else
         lambda b: shares_io.read_shared_input(b, device="cpu"))(data)


def _capture_args(monkeypatch, name):
    seen = {}
    monkeypatch.setattr(cli, name, lambda args: seen.update(vars(args)))
    return seen


def test_layered_config_flag_over_env_over_file(tmp_path, monkeypatch):
    """--config (TOML or JSON) < COCIRCOM_* < flags, as in the JAX package;
    COCIRCOM_DEVICE takes cuda and cpu."""
    (tmp_path / "c.toml").write_text('threshold = 2\nnet_config = "file.json"\ndevice = "cpu"\n')
    (tmp_path / "c.json").write_text(json.dumps({"threshold": 2, "net_config": "file.json"}))
    base = ["generate-proof", "groth16", "--zkey", "z", "--witness", "w", "--out", "o"]
    for cfg in ("c.toml", "c.json"):
        argv = ["--config", str(tmp_path / cfg)] + base
        seen = _capture_args(monkeypatch, "cmd_generate_proof")
        cli.main(argv)
        assert seen["threshold"] == 2 and seen["net_config"] == "file.json"
        assert seen["device"] == ("cpu" if cfg == "c.toml" else "cuda")
        monkeypatch.setenv("COCIRCOM_THRESHOLD", "3")
        monkeypatch.setenv("COCIRCOM_DEVICE", "cuda")
        cli.main(argv)
        assert seen["threshold"] == 3 and seen["device"] == "cuda"
        layered = cli._layered_config(argv)
        ref = ref_cli._layered_config(argv)
        assert layered == ref
        cli.main(["--device", "cpu", "--config", str(tmp_path / cfg)] + base[:2]
                 + ["--threshold", "4"] + base[2:])
        assert seen["threshold"] == 4 and seen["device"] == "cpu"
        monkeypatch.delenv("COCIRCOM_THRESHOLD")
        monkeypatch.delenv("COCIRCOM_DEVICE")
    monkeypatch.setenv("COCIRCOM_DEVICE", "tpu")
    with pytest.raises(Exception, match="cuda, cuda:N or cpu"):
        cli.main(base)


DEVICE_SUBCOMMANDS = {
    "split-witness": ["split-witness", "--witness", "w.wtns", "--num-publics", "2",
                      "--out-dir", "out"],
    "generate-proof": ["generate-proof", "groth16", "--zkey", "z", "--witness", "w",
                       "--out", "o"],
    "translate-witness": ["translate-witness", "--witness", "w", "--net-config", "n",
                          "--out", "o"],
    "split-input": ["split-input", "--input", "i", "--circuit", "c", "--out-dir", "out"],
    "merge-input-shares": ["merge-input-shares", "a", "b", "--out", "o"],
    "generate-witness": ["generate-witness", "--circuit", "c", "--input", "i", "--out", "o"],
}


@pytest.mark.parametrize("value", [None, "0", "1"])
def test_leak_guard_needs_the_explicit_switch(value, monkeypatch):
    """leak_guard raises, naming the switch, unless
    COCIRCOM_ALLOW_LEAKY_LOGS=1, and leaky_logs_allowed agrees with the JAX
    package's."""
    from cocircom_tpu.utils import trace as ref_trace
    from cocircom_tpu_torch.utils.trace import leak_guard, leaky_logs_allowed

    if value is None:
        monkeypatch.delenv("COCIRCOM_ALLOW_LEAKY_LOGS", raising=False)
    else:
        monkeypatch.setenv("COCIRCOM_ALLOW_LEAKY_LOGS", value)
    assert leaky_logs_allowed() == ref_trace.leaky_logs_allowed() == (value == "1")
    if value == "1":
        leak_guard("an opened share")
    else:
        with pytest.raises(PermissionError, match="COCIRCOM_ALLOW_LEAKY_LOGS=1"):
            leak_guard("an opened share")


@pytest.mark.parametrize("sub", list(DEVICE_SUBCOMMANDS))
def test_computing_subcommands_exit_without_a_card(sub, tmp_path, capsys, monkeypatch):
    """Without --device cpu every subcommand that computes exits non-zero
    with resolve_device's message before it reads a file or starts a
    prover; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default device exists")
    import cocircom_tpu_torch.snark.groth16 as groth16

    def never(*a, **k):
        raise AssertionError("the prover started without a device")

    monkeypatch.setattr(groth16.CoGroth16, "prove", never)
    monkeypatch.chdir(tmp_path)  # no file it names exists
    code, out = run_cli(capsys, *DEVICE_SUBCOMMANDS[sub])
    assert code != 0 and "CUDA" in out and "pass device='cpu'" in out
    monkeypatch.setenv("COCIRCOM_DEVICE", "cuda")
    code, out = run_cli(capsys, *DEVICE_SUBCOMMANDS[sub])
    assert code != 0 and "CUDA" in out


FIT_SRC = """
pragma circom 2.0.0;
template Mix() {
    signal input a;
    signal input b;
    signal output y;
    signal s;
    signal t;
    signal u;
    s <== a + b;
    t <== s * a;
    u <== t + 3 * b;
    y <== u * s;
}
component main = Mix();
"""


def test_fit_keep_labels_equals_reference():
    """The layout fit of one inline source from two sample witnesses gives
    the JAX package's labels."""
    from cocircom_tpu.vm.compiler import compile_circom as ref_compile
    from cocircom_tpu.vm.mpc_vm import WitnessExtension as RefWitnessExtension

    ref_c = ref_curve_by_name("bn254")
    inputs = [{"a": 3, "b": 5}, {"a": 11, "b": 2}]
    cc = ref_compile(FIT_SRC, ref_c)
    wants = [RefWitnessExtension(None, cc).run_host(inp) for inp in inputs]
    got = fit_keep_labels(FIT_SRC, BN254, [], inputs, wants)
    ref = ref_fit_keep_labels(FIT_SRC, ref_c, [], inputs, wants)
    assert got == ref
    keep, n_labels = got
    pinned = compile_circom(FIT_SRC, BN254, keep_labels=keep, n_labels=n_labels)
    assert WitnessExtension(None, pinned).run_host(inputs[1]) == wants[1]


def test_gen_cert_names_the_missing_package(tmp_path, monkeypatch):
    """Where `cryptography` does not import, gen-cert fails loudly and names
    it, and writes nothing."""
    import builtins

    real_import = builtins.__import__

    def no_cryptography(name, *args, **kwargs):
        if name == "cryptography" or name.startswith("cryptography."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cryptography)
    with pytest.raises(ImportError, match="gen-cert needs the 'cryptography' package"):
        cli.main(["gen-cert", "--key-out", str(tmp_path / "k.pem"),
                  "--cert-out", str(tmp_path / "c.pem")])
    assert not list(tmp_path.iterdir())
