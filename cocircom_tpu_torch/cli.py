"""co-circom command line of the port: the nine subcommands.

    python -m cocircom_tpu_torch.cli [--device cuda|cpu] [--config FILE] <subcommand> ...

The upstream pipeline (co-circom/src/bin/co-circom.rs:82-97): split-witness,
split-input, merge-input-shares, generate-witness, translate-witness,
generate-proof, verify; plus setup (the single-party trusted setup that
writes a snarkjs .zkey) and gen-cert (a self-signed TLS certificate).  The
flags, output file names and messages are the JAX package's (its cli.py), and
so are the file formats (io/shares_io.py).

Configuration is layered: a TOML or JSON file (--config), then the
environment (COCIRCOM_<KEY>), then the flags.

Each party of a multi-party run is its own process.  --net-config points to
a JSON file {"my_id": k, "key_path"?: ..., "parties": [{"id", "host", "port",
"cert_path"?}, ...]}; the parties meet over a TCP mesh (mpc/net.py), under
mutual TLS when key_path and every party's cert_path are there.

--device picks where the shares and the prover run: the card (`cuda`, the
default, or `cuda:N`) or, only when asked for, `cpu`.  Without a card a
subcommand that puts shares on a device exits non-zero; nothing falls back
to the CPU.  setup, verify and gen-cert compute on the host alone.
With COCIRCOM_TRACE=1, generate-proof prints a span table (startup, mesh,
zkey read, the prover's spans; seconds and bytes), the kernel launch counts
of the set-up and of the proof apart, and the process's peak device memory
to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys


def _load_net(path: str):
    """Net config JSON: {"my_id": k, "key_path"?: ..., "parties":
    [{"id", "host", "port", "cert_path"?}, ...]}.  With key_path and every
    party's cert_path the mesh runs mutual TLS (mpc-net/src/config.rs:52-98).
    Returns (my_id, addrs, TlsConfig or None)."""
    with open(path) as fh:
        cfg = json.load(fh)
    n = len(cfg["parties"])
    my_id = int(cfg["my_id"])
    addrs = [None] * n
    certs = [None] * n
    for p in cfg["parties"]:
        addrs[int(p["id"])] = (p.get("host", "127.0.0.1"), int(p["port"]))
        certs[int(p["id"])] = p.get("cert_path")
    tls = None
    if cfg.get("key_path") and all(certs):
        from .mpc.net import TlsConfig

        tls = TlsConfig(cfg["key_path"], certs[my_id],
                        party_cert_paths={i: c for i, c in enumerate(certs)})
    return my_id, addrs, tls


def _read(path: str, mode: str = "rb"):
    with open(path, mode) as fh:
        return fh.read()


def _write(path: str, data) -> None:
    with open(path, "wb" if isinstance(data, bytes) else "w") as fh:
        fh.write(data)
    print(f"wrote {path}")


def _device(args):
    """The device of a subcommand that computes: the card unless --device
    names another, with the CUDA context made and the kernels loaded (built
    first where they are not).  Exits with resolve_device's message when no
    card is there."""
    import torch

    from .ops.field import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"cocircom_tpu_torch.cli: {e}") from e
    if device.type == "cuda":
        from .ops import kernels

        torch.cuda.set_device(device)
        torch.cuda.init()
        kernels.load_all()
    return device


def _network(net_config: str, device):
    from .mpc.net import TcpNetwork

    my_id, addrs, tls = _load_net(net_config)
    return TcpNetwork(my_id, addrs, tls=tls, device=device)


def _driver(protocol: str, curve, net_config: str | None, device, threshold: int = 1):
    if protocol == "plain":
        from .mpc.driver import PlainDriver

        return PlainDriver(curve, device=device)
    if not net_config:
        raise SystemExit(f"protocol {protocol} needs --net-config")
    if protocol == "rep3":
        from .mpc.rep3 import Rep3Driver

        return Rep3Driver(curve, _network(net_config, device), device=device)
    if protocol == "shamir":
        from .mpc.shamir import ShamirDriver

        return ShamirDriver(curve, _network(net_config, device), threshold, device=device)
    raise SystemExit(f"unknown protocol {protocol}")


def _close(driver) -> None:
    """Tear down a driver's mesh (the plain driver has none)."""
    net = getattr(driver, "net", None)
    if net is not None:
        net.close()


def cmd_split_witness(args):
    device = _device(args)
    from .io.shares_io import shared_witness_from_split
    from .io.witness import read_wtns
    from .snark.shared import split_witness_plain, split_witness_rep3, split_witness_shamir

    w = read_wtns(_read(args.witness))
    n_public = args.num_publics
    if n_public is None:
        if not args.r1cs:
            raise SystemExit("need --num-publics or --r1cs")
        from .io.r1cs import read_r1cs

        r = read_r1cs(_read(args.r1cs))
        n_public = r.n_pub_in + r.n_pub_out
    os.makedirs(args.out_dir, exist_ok=True)
    if args.protocol == "rep3":
        shares = split_witness_rep3(w, n_public, device=device)
    elif args.protocol == "shamir":
        shares = split_witness_shamir(w, n_public, args.threshold, args.num_parties,
                                      device=device)
    else:
        shares = [split_witness_plain(w, n_public, device=device)]
    for i, s in enumerate(shares):
        _write(os.path.join(args.out_dir, f"witness.wtns.{i}.shared"),
               shared_witness_from_split(args.protocol, w.curve, s))


def cmd_generate_proof(args):
    from .utils.trace import Tracer

    tr = Tracer()  # COCIRCOM_TRACE
    with tr.span("startup (torch, CUDA context, kernels)"):
        device = _device(args)
    if device.type == "cuda":
        import torch

        tr.sync = torch.cuda.synchronize
    from .io.shares_io import shared_witness_to_split

    with tr.span("read witness"):
        protocol, curve, shared = shared_witness_to_split(_read(args.witness), device=device)
    # the mesh comes up before the zkey is read: the peers' reads overlap
    with tr.span("mesh (connect, PRF setup)"):
        d = _driver(protocol, curve, args.net_config, device, args.threshold)
    tr.net = getattr(d, "net", None)
    if args.proof_system == "groth16":
        from .io.jsonio import dump_groth16_proof
        from .io.zkey import read_groth16_zkey as read_zkey
        from .snark.groth16 import CoGroth16 as Prover

        def dump(proof):
            return dump_groth16_proof(curve, proof["pi_a"], proof["pi_b"], proof["pi_c"])
    else:
        from .io.jsonio import dump_plonk_proof
        from .io.plonk_zkey import read_plonk_zkey as read_zkey
        from .snark.plonk import CoPlonk as Prover

        def dump(proof):
            return dump_plonk_proof(curve, proof)
    from .ops import kernels

    with tr.span("read zkey"):
        zk = read_zkey(_read(args.zkey), device=device)
    # the report's `launches` are the proof's alone; what the set-up
    # launched (the zkey read's Montgomery conversions) is reported apart
    tr.setup_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    with tr.span(f"generate-proof {args.proof_system}"):
        proof = Prover(d, tracer=tr).prove(zk, shared)
    out = dump(proof)
    _close(d)
    tr.report()
    _write(args.out, out)
    if args.public_out:
        from .io.jsonio import dump_public_inputs

        _write(args.public_out, dump_public_inputs(shared.public_inputs[1:]))


def cmd_verify(args):
    from .io.jsonio import parse_public_inputs

    data = _read(args.proof)
    vk_data = _read(args.vk)
    publics = parse_public_inputs(_read(args.public))
    if args.proof_system == "groth16":
        from .io.jsonio import parse_groth16_proof, parse_groth16_vk
        from .snark.groth16_verify import verify_groth16

        ok = verify_groth16(parse_groth16_vk(vk_data), parse_groth16_proof(data), publics)
    else:
        from .io.jsonio import parse_plonk_proof, parse_plonk_vk
        from .snark.plonk_verify import verify_plonk

        ok = verify_plonk(parse_plonk_vk(vk_data), parse_plonk_proof(data), publics)
    print("verification: " + ("OK" if ok else "FAILED"))
    sys.exit(0 if ok else 1)


def cmd_setup(args):
    """Trusted setup from an .r1cs (`snarkjs {groth16,plonk} setup`): writes a
    snarkjs-format .zkey and, with --vk, verification_key.json.  A
    single-party setup gives development keys; production keys come from a
    phase-2 ceremony."""
    from .io.r1cs import read_r1cs

    r1cs = read_r1cs(_read(args.r1cs))
    seed = args.seed.encode() if args.seed else None
    if args.proof_system == "groth16":
        from .io.jsonio import dump_groth16_vk as dump_vk
        from .snark.setup import groth16_setup as run_setup
    else:
        from .io.jsonio import dump_plonk_vk as dump_vk
        from .snark.plonk_setup import plonk_setup as run_setup
    zkey_bytes, vk = run_setup(r1cs, seed=seed)
    with open(args.zkey, "wb") as fh:
        fh.write(zkey_bytes)
    if args.vk:
        with open(args.vk, "w") as fh:
            fh.write(dump_vk(vk))
    print(f"setup: {args.proof_system}, {r1cs.n_constraints} constraints, "
          f"{r1cs.n_wires} wires -> {args.zkey}")


def cmd_translate_witness(args):
    """A REP3 share -> a Shamir (t = 1) share (bridges/rep3_to_shamir.rs)."""
    device = _device(args)
    from .io.shares_io import shared_witness_from_split, shared_witness_to_split
    from .mpc.bridges import translate_rep3_to_shamir
    from .snark.groth16 import SharedWitness

    protocol, curve, shared = shared_witness_to_split(_read(args.witness), device=device)
    if protocol != "rep3":
        raise SystemExit("translate-witness expects a rep3 share as input")
    net = _network(args.net_config, device)
    new_share = translate_rep3_to_shamir(curve, net, shared.witness)
    net.close()
    _write(args.out, shared_witness_from_split(
        "shamir", curve, SharedWitness(shared.public_inputs, new_share)))


def cmd_gen_cert(args):
    from .mpc.net import gen_self_signed_cert

    gen_self_signed_cert(args.key_out, args.cert_out, args.dns_name)
    print(f"wrote {args.key_out} and {args.cert_out}")


def cmd_split_input(args):
    """Split an input.json into per-party SharedInput files: the circuit's
    public signals ({public [...]}) in the clear, the others secret-shared
    (bin/co-circom.rs run_split_input, :255-335)."""
    if args.protocol != "rep3":
        raise SystemExit("only REP3 is supported for splitting inputs")
    device = _device(args)
    from .fields.params import curve_by_name
    from .io.shares_io import write_shared_input
    from .snark.shared import split_input_rep3
    from .vm.compiler import compile_circom

    curve = curve_by_name(args.curve)
    parsed = compile_circom(_read(args.circuit, "r"), curve, link=args.link or [])
    inputs = json.loads(_read(args.input, "r"))
    shares = split_input_rep3(curve, inputs, set(parsed.public_names), device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.basename(args.input)
    for i, s in enumerate(shares):
        _write(os.path.join(args.out_dir, f"{base}.{i}.shared"),
               write_shared_input("rep3", curve.name, s))


def cmd_merge_input_shares(args):
    """Union the SharedInput files of independent input providers
    (bin/co-circom.rs run_merge_input_shares, :338-368)."""
    if len(args.inputs) < 2:
        raise SystemExit("need at least two input shares to merge")
    device = _device(args)
    from .io.shares_io import read_shared_input, write_shared_input
    from .snark.shared import merge_inputs

    merged = proto = curve = None
    for path in args.inputs:
        protocol, c, si = read_shared_input(_read(path), device=device)
        if merged is None:
            merged, proto, curve = si, protocol, c
        else:
            if protocol != proto or c.name != curve.name:
                raise SystemExit("protocol/curve mismatch between input shares")
            merged = merge_inputs(merged, si)
    _write(args.out, write_shared_input(proto, curve.name, merged))


def _compile_cli(args, curve):
    """compile_circom with the optional --r1cs layout pin: the r1cs's
    wire2label map forces the witness layout to the kept set circom chose
    when it made that r1cs and its zkey (vm/compiler.py keep_labels)."""
    from .vm.compiler import compile_circom

    kw = {}
    if args.r1cs:
        from .io.r1cs import read_r1cs

        r1 = read_r1cs(_read(args.r1cs))
        kw = {"keep_labels": r1.wire_mapping[1:], "n_labels": r1.n_labels}
    return compile_circom(_read(args.circuit, "r"), curve, link=args.link or [], **kw)


def cmd_generate_witness(args):
    """The witness extension.  plain: input.json -> .wtns on the host path.
    rep3: a .shared SharedInput file -> run_shared_input over the mesh ->
    a .shared witness (no cleartext witness ever exists)
    (bin/co-circom.rs run_generate_witness, :369-404)."""
    if args.protocol not in ("plain", "rep3"):
        raise SystemExit("generate-witness supports plain and rep3 (translate a rep3 "
                         "witness to shamir with translate-witness)")
    device = _device(args)
    from .fields.params import curve_by_name
    from .vm.mpc_vm import WitnessExtension

    if args.protocol == "plain":
        from .io.witness import write_wtns

        curve = curve_by_name(args.curve)
        parsed = _compile_cli(args, curve)
        inputs = json.loads(_read(args.input, "r"))
        vm = WitnessExtension(_driver("plain", curve, None, device), parsed)
        _write(args.out, write_wtns(curve, vm.run_plain_inputs(inputs)))
        return
    from .io.shares_io import read_shared_input, shared_witness_from_split

    protocol, curve, si = read_shared_input(_read(args.input), device=device)
    if protocol != "rep3":
        raise SystemExit(f"input share file is {protocol}, expected rep3")
    parsed = _compile_cli(args, curve)
    d = _driver("rep3", curve, args.net_config, device)
    sw = WitnessExtension(d, parsed).run_shared_input(si)
    _close(d)
    _write(args.out, shared_witness_from_split("rep3", curve, sw))


_DEVICE = re.compile(r"cpu|cuda(:\d+)?")


def _device_name(s: str) -> str:
    if not _DEVICE.fullmatch(s):
        raise argparse.ArgumentTypeError(f"device must be cuda, cuda:N or cpu, not {s!r}")
    return s


def _layered_config(argv):
    """Config file (--config, TOML or JSON), then COCIRCOM_<KEY>, then the
    flags (co-circom/src/lib.rs:447-482).  Returns the defaults the file and
    the environment set, by destination name."""
    cfgpath = None
    argv = list(sys.argv[1:] if argv is None else argv)
    for i, a in enumerate(argv):
        if a == "--config" and i + 1 < len(argv):
            cfgpath = argv[i + 1]
        elif a.startswith("--config="):
            cfgpath = a.split("=", 1)[1]
    layered: dict = {}
    if cfgpath:
        raw = _read(cfgpath)
        if cfgpath.endswith(".toml"):
            import tomllib

            layered.update(tomllib.loads(raw.decode()))
        else:
            layered.update(json.loads(raw))
    for key in ("protocol", "curve", "net_config", "threshold", "device", "out_dir", "link"):
        env = os.environ.get("COCIRCOM_" + key.upper())
        if env is not None:
            layered[key] = env
    if "threshold" in layered:
        layered["threshold"] = int(layered["threshold"])
    if "device" in layered:
        layered["device"] = _device_name(str(layered["device"]))
    return layered


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cocircom_tpu_torch.cli",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", help="TOML/JSON config file (lowest layer)")
    ap.add_argument("--device", default="cuda", type=_device_name,
                    help="cuda (default), cuda:N or cpu: where shares and provers run")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("split-witness", help="split a wtns into MPC shares")
    sp.add_argument("--witness", required=True)
    sp.add_argument("--r1cs")
    sp.add_argument("--num-publics", type=int)
    sp.add_argument("--protocol", default="rep3", choices=["plain", "rep3", "shamir"])
    sp.add_argument("--threshold", type=int, default=1)
    sp.add_argument("--num-parties", type=int, default=3)
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_split_witness)

    sp = sub.add_parser("generate-proof", help="run the collaborative prover")
    sp.add_argument("proof_system", choices=["groth16", "plonk"])
    sp.add_argument("--zkey", required=True)
    sp.add_argument("--witness", required=True, help=".shared witness file")
    sp.add_argument("--net-config", help="JSON net config (omit for plain)")
    sp.add_argument("--threshold", type=int, default=1)
    sp.add_argument("--out", required=True)
    sp.add_argument("--public-out")
    sp.set_defaults(fn=cmd_generate_proof)

    sp = sub.add_parser("verify", help="verify a proof (on the host)")
    sp.add_argument("proof_system", choices=["groth16", "plonk"])
    sp.add_argument("--proof", required=True)
    sp.add_argument("--vk", required=True)
    sp.add_argument("--public", required=True)
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("setup", help="trusted setup: .r1cs -> .zkey (+ vk json), on the host")
    sp.add_argument("proof_system", choices=["groth16", "plonk"])
    sp.add_argument("r1cs")
    sp.add_argument("zkey")
    sp.add_argument("--vk", help="also write verification_key.json here")
    sp.add_argument("--seed", help="deterministic toxic waste (tests only)")
    sp.set_defaults(fn=cmd_setup)

    sp = sub.add_parser("translate-witness", help="rep3 share -> shamir share")
    sp.add_argument("--witness", required=True)
    sp.add_argument("--net-config", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_translate_witness)

    sp = sub.add_parser("gen-cert", help="generate a self-signed TLS cert+key")
    sp.add_argument("--key-out", required=True)
    sp.add_argument("--cert-out", required=True)
    sp.add_argument("--dns-name", default="localhost")
    sp.set_defaults(fn=cmd_gen_cert)

    sp = sub.add_parser("split-input", help="split input.json into MPC shares")
    sp.add_argument("--input", required=True, help="input.json")
    sp.add_argument("--circuit", required=True, help=".circom source")
    sp.add_argument("--curve", default="bn254")
    sp.add_argument("--link", action="append", help="circom library search dir")
    sp.add_argument("--protocol", default="rep3", choices=["rep3"])
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_split_input)

    sp = sub.add_parser("merge-input-shares", help="merge .shared input files")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_merge_input_shares)

    sp = sub.add_parser("generate-witness", help="MPC witness extension")
    sp.add_argument("--circuit", required=True, help=".circom source")
    sp.add_argument("--input", required=True,
                    help="input.json (plain) or a .shared SharedInput file (rep3)")
    sp.add_argument("--curve", default="bn254")
    sp.add_argument("--link", action="append", help="circom library search dir")
    sp.add_argument("--r1cs", help="snarkjs .r1cs whose wire2label map pins the witness "
                    "layout (use when proving against that r1cs's zkey)")
    sp.add_argument("--protocol", default="plain", choices=["plain", "rep3", "shamir"])
    sp.add_argument("--net-config")
    sp.add_argument("--threshold", type=int, default=1)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_generate_witness)
    return ap


def main(argv=None):
    ap = build_parser()
    layered = _layered_config(argv)
    if layered:
        # defaults only: flags given on the command line still win
        for action in ap._actions:
            if action.dest in layered:
                action.default = layered[action.dest]
        for sp_action in ap._subparsers._group_actions[0].choices.values():
            for action in sp_action._actions:
                if action.dest in layered:
                    action.default = layered[action.dest]
                    action.required = False
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
