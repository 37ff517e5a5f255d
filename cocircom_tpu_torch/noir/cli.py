"""co-noir command line of the port: the eight noir subcommands over MPC.

    python -m cocircom_tpu_torch.noir.cli [--device cuda|cpu] <subcommand> ...

Parity: upstream co-noir/co-noir/src/bin/co-noir.rs:62-80 —
  split-witness | split-input | merge-input-shares | generate-witness |
  translate-witness | generate-proof | create-vk | verify
The flags, output file names, messages and file formats are the JAX
package's (its noir/cli.py), so either package reads the other's files:
  * .shared files use the fixed-schema wire codec (mpc/codec.py) with a
    {"protocol", "curve", "kind", ...} header — no pickle — and the share
    components in the JAX package's layout, 16-bit limbs in uint32, limb
    axis first (the port's 32-bit limbs are repacked on write and read);
  * proofs use the Barretenberg HonkProof buffer layout (u32 BE count +
    32-byte BE field elements, ultrahonk types.rs:79-137);
  * vk files are JSON with hex commitments.

CRS: --crs file --crs-g1 <g1.dat> --crs-g2 <g2.dat> reads a powers-of-tau
setup in Aztec Ignition's layout (the first circuit-size points of g1.dat;
parse/crs.rs): generate-proof commits by MSM over the shares with it
(honk/crs.py PointCrs), create-vk by the device MSM (FileCrs with
driver_msm).  --crs test (the default) is the insecure known-tau TestCrs
for tests; pass --crs-seed to pin the same tau in every party.

Each party of a multi-party run is its own process; --net-config points to
the JSON file of the circom CLI ({"my_id", "key_path"?, "parties": [{"id",
"host", "port", "cert_path"?}, ...]}): a TCP mesh, under mutual TLS when
key_path and every party's cert_path are given.

--device picks where shares and provers run: the card (`cuda`, the
default, or `cuda:N`) or, only when asked for, `cpu`.  Without a card a
subcommand that puts shares on a device exits non-zero; nothing falls back
to the CPU.  create-vk evaluates the key's polynomials at tau on the
device; merge-input-shares and verify compute on the host alone.  With
COCIRCOM_TRACE=1, generate-proof prints its span table (start-
up, mesh, builder, the prover's spans), the kernel launches of the proof
and the process's peak device memory to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..cli import _device, _device_name, _network, _read


def _codec():
    from ..mpc import codec

    return codec


def _curve():
    from ..fields.params import BN254

    return BN254


def _field(device):
    from ..ops.field import get_field

    c = _curve()
    return get_field(c.fr.p, c.name + ".fr", device)


def _write_shared(path, kind: str, payload: dict, protocol: str = "rep3"):
    blob = _codec().encode({"protocol": protocol, "curve": "bn254",
                            "kind": kind, **payload})
    with open(path, "wb") as fh:
        fh.write(blob)
    print(f"wrote {path}")


def _read_shared(path, kind: str) -> dict:
    obj = _codec().decode(_read(path))
    if obj.get("kind") != kind:
        raise SystemExit(f"{path}: expected {kind} share file, got "
                         f"{obj.get('kind')}")
    return obj


def _to_file(t):
    from ..io.shares_io import _to_file

    return _to_file(t)


def _share_from_file(obj, device):
    from ..io.shares_io import _from_file
    from ..mpc.rep3 import Rep3FieldShare

    return Rep3FieldShare(_from_file(obj["a"], device), _from_file(obj["b"], device))


def _share_witness_vec(values: list[int], device):
    """ints -> 3 REP3 (a, b) component pairs in the file layout."""
    from ..mpc.rep3 import share_field_vec

    f = _field(device)
    return [(_to_file(s.a), _to_file(s.b)) for s in share_field_vec(f, f.encode(values))]


def cmd_split_witness(args):
    """noir witness .gz -> 3 REP3 witness-share files (co-noir.rs
    run_split_witness / lib.rs share_rep3:427)."""
    device = _device(args)
    from .acir import load_program_json, parse_witness_stack

    circuits, _abi = load_program_json(args.circuit)
    stack = parse_witness_stack(_read(args.witness))
    wmap = stack[0][1]
    varnum = circuits[0].current_witness_index + 1
    values = [wmap.get(i, 0) for i in range(varnum)]
    os.makedirs(args.out_dir, exist_ok=True)
    for i, (a, b) in enumerate(_share_witness_vec(values, device)):
        _write_shared(os.path.join(args.out_dir, f"witness.gz.{i}.shared"),
                      "noir-witness", {"a": a, "b": b})


def cmd_split_input(args):
    """Prover.toml -> 3 SharedInput files (lib.rs share_input_rep3:482)."""
    device = _device(args)
    import tomllib

    from .acir import load_program_json
    from .solver import bind_toml_inputs

    circuits, abi = load_program_json(args.circuit)
    inputs = tomllib.loads(_read(args.input).decode())
    values = bind_toml_inputs(abi, inputs, _curve().fr.p)
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.basename(args.input)
    for i, (a, b) in enumerate(_share_witness_vec(values, device)):
        _write_shared(os.path.join(args.out_dir, f"{base}.{i}.shared"),
                      "noir-input", {"a": a, "b": b, "offset": 0})


def cmd_merge_input_shares(args):
    """Concatenate input share segments from independent providers in
    witness order (co-noir.rs run_merge_input_shares)."""
    parts = [_read_shared(p, "noir-input") for p in args.inputs]
    parts.sort(key=lambda o: int(o.get("offset", 0)))
    a = np.concatenate([np.asarray(p["a"]) for p in parts], axis=-1)
    b = np.concatenate([np.asarray(p["b"]) for p in parts], axis=-1)
    _write_shared(args.out, "noir-input", {"a": a, "b": b, "offset": 0})


def cmd_generate_witness(args):
    """REP3 ACVM witness extension over the TCP mesh."""
    device = _device(args)
    from ..mpc.rep3 import Rep3Driver
    from .acir import load_program_json
    from .rep3_driver import Rep3NoirDriver
    from .solver import AcvmSolver, Shared, is_shared

    circuits, _abi = load_program_json(args.circuit)
    c = circuits[0]
    vec = _share_from_file(_read_shared(args.input, "noir-input"), device)
    net = _network(args.net_config, device)
    d = Rep3NoirDriver(Rep3Driver(_curve(), net, device=device))
    solver = AcvmSolver(d, c)
    params = sorted(set(c.private_parameters) | set(c.public_parameters))
    for k, w in enumerate(params):
        solver.witness[w] = Shared(d.d.index_share(vec, k))
    out = solver.solve()
    net.close()
    varnum = c.current_witness_index + 1
    handles = []
    for i in range(varnum):
        v = out.get(i, 0)
        handles.append(v.v if is_shared(v) else d.promote(int(v)))
    stacked = d.d.stack_shares(handles)
    _write_shared(args.out, "noir-witness", {"a": _to_file(stacked.a),
                                             "b": _to_file(stacked.b)})


def cmd_translate_witness(args):
    """REP3 noir witness share -> Shamir (t = 1) (bridges parity)."""
    device = _device(args)
    from ..mpc.bridges import translate_rep3_to_shamir

    share = _share_from_file(_read_shared(args.witness, "noir-witness"), device)
    net = _network(args.net_config, device)
    new = translate_rep3_to_shamir(_curve(), net, share)
    net.close()
    _write_shared(args.out, "noir-witness-shamir", {"a": _to_file(new)},
                  protocol="shamir")


def _build_builder(args, driver=None, wshare=None):
    """Builder in provider mode (honk/co_builder.py) so memory circuits
    get the oblivious ROM/RAM gate structure.  With no driver (create-vk),
    a plain driver over zeros on the host gives the IDENTICAL structure —
    the vk only commits to value-independent precomputed polynomials."""
    from ..honk.builder import UltraCircuitBuilder, acir_to_format
    from ..honk.co_builder import MpcBuilderValues
    from .acir import load_program_json

    circuits, _abi = load_program_json(args.circuit)
    c = circuits[0]
    af = acir_to_format(c)
    if driver is None:
        from ..mpc.driver import PlainDriver

        driver = PlainDriver(_curve(), device="cpu")
        wshare = driver.promote_public(driver.fr.zeros((af.varnum,)))
    m = MpcBuilderValues(driver, wshare)
    return UltraCircuitBuilder(af, [0] * af.varnum, mpc=m), c


def _circuit_size(builder) -> int:
    """The proving key's circuit size: the builder finalized (as
    create_proving_key does it, once), its dyadic size."""
    if not builder.circuit_finalized:
        builder.add_gates_to_ensure_all_polys_are_non_zero()
        builder.finalize_circuit()
    return builder.compute_dyadic_size()


def _crs(args, builder, driver=None, device=None):
    """The setup of --crs: TestCrs (known tau; evaluated on `driver`'s
    device when given), or the .dat files' first circuit-size points: on
    `device` for the co-prover (PointCrs), through `driver`'s MSM for the
    vk (FileCrs)."""
    from ..honk.crs import FileCrs, PointCrs, TestCrs, driver_msm

    if args.crs == "file":
        if not (args.crs_g1 and args.crs_g2):
            raise SystemExit("--crs file needs --crs-g1 and --crs-g2")
        n = _circuit_size(builder)
        if driver is not None:
            return FileCrs(args.crs_g1, args.crs_g2, n, msm=driver_msm(driver))
        return PointCrs.from_dat(args.crs_g1, args.crs_g2, n, device)
    seed = (args.crs_seed.encode()
            if args.crs_seed else b"cocircom-tpu insecure test crs")
    return TestCrs(seed, driver=driver)


def cmd_generate_proof(args):
    """co-UltraHonk proof over the TCP mesh (prover.rs:47)."""
    from ..utils.trace import Tracer

    tr = Tracer()  # COCIRCOM_TRACE
    with tr.span("startup (torch, CUDA context, kernels)"):
        device = _device(args)
    if device.type == "cuda":
        import torch

        tr.sync = torch.cuda.synchronize
    from ..honk.co_prover import CoUltraHonk
    from ..honk.prover import proof_to_buffer
    from ..mpc.rep3 import Rep3Driver
    from ..ops import kernels

    with tr.span("read witness"):
        wshare = _share_from_file(_read_shared(args.witness, "noir-witness"), device)
    with tr.span("mesh (connect, PRF setup)"):
        net = _network(args.net_config, device)
        d = Rep3Driver(_curve(), net, device=device)
    tr.net = net
    tr.setup_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    with tr.span("builder"):
        builder, _c = _build_builder(args, driver=d, wshare=wshare)
    with tr.span("setup (--crs)"):
        crs = _crs(args, builder, device=device)
    with tr.span("generate-proof ultrahonk"):
        proof = CoUltraHonk(d, crs, tracer=tr).prove(builder, wshare)
    net.close()
    tr.report()
    with open(args.out, "wb") as fh:
        fh.write(proof_to_buffer(proof))
    print(f"wrote {args.out}")


def _point_json(c):
    return None if c is None else [hex(c[0].v), hex(c[1].v)]


def cmd_create_vk(args):
    """Verification key JSON (co-noir.rs CreateVK / run_create_vk): the
    circuit is built on the host, its precomputed polynomials committed on
    the device by a plain driver: evaluated at tau (--crs test) or by MSM
    over the file's points (--crs file)."""
    from ..honk.proving_key import create_keys
    from ..mpc.driver import PlainDriver

    device = _device(args)
    builder, _c = _build_builder(args)
    _pk, vk = create_keys(builder, _crs(args, builder, PlainDriver(_curve(), device=device)))
    data = {
        "circuit_size": vk.circuit_size,
        "num_public_inputs": vk.num_public_inputs,
        "pub_inputs_offset": vk.pub_inputs_offset,
        "commitments": [_point_json(c) for c in vk.commitments],
        "g2_x": [[hex(vk.g2_x[0].c0.v), hex(vk.g2_x[0].c1.v)],
                 [hex(vk.g2_x[1].c0.v), hex(vk.g2_x[1].c1.v)]],
    }
    with open(args.out, "w") as fh:
        json.dump(data, fh)
    print(f"wrote {args.out}")


def cmd_verify(args):
    from ..honk import verifier
    from ..honk.prover import proof_from_buffer
    from ..honk.proving_key import VerifyingKey
    from ..pairing.tower import Fp, Fp2

    data = json.loads(_read(args.vk))
    p = _curve().fq.p

    def pt(c):
        return None if c is None else (Fp(int(c[0], 16), p), Fp(int(c[1], 16), p))

    g2 = (Fp2(Fp(int(data["g2_x"][0][0], 16), p), Fp(int(data["g2_x"][0][1], 16), p)),
          Fp2(Fp(int(data["g2_x"][1][0], 16), p), Fp(int(data["g2_x"][1][1], 16), p)))
    vk = VerifyingKey(
        g2_x=g2,
        circuit_size=data["circuit_size"],
        num_public_inputs=data["num_public_inputs"],
        pub_inputs_offset=data["pub_inputs_offset"],
        commitments=[pt(c) for c in data["commitments"]],
    )
    proof = proof_from_buffer(_read(args.proof))
    ok = verifier.verify(proof, vk)
    print("verification: " + ("OK" if ok else "FAILED"))
    sys.exit(0 if ok else 1)


def _crs_args(sp):
    sp.add_argument("--crs", default="test", choices=["test", "file"])
    sp.add_argument("--crs-seed", help="--crs test: the seed of tau")
    sp.add_argument("--crs-g1", help="--crs file: the G1 points (Ignition g1.dat layout)")
    sp.add_argument("--crs-g2", help="--crs file: [tau]G2 (g2.dat)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cocircom_tpu_torch.noir.cli",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", type=_device_name,
                    help="cuda (default), cuda:N or cpu: where shares and provers run")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("split-witness")
    sp.add_argument("--witness", required=True, help="noir witness .gz")
    sp.add_argument("--circuit", required=True, help="program artifact JSON")
    sp.add_argument("--protocol", default="rep3", choices=["rep3"])
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_split_witness)

    sp = sub.add_parser("split-input")
    sp.add_argument("--input", required=True, help="Prover.toml")
    sp.add_argument("--circuit", required=True)
    sp.add_argument("--protocol", default="rep3", choices=["rep3"])
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_split_input)

    sp = sub.add_parser("merge-input-shares")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_merge_input_shares)

    sp = sub.add_parser("generate-witness")
    sp.add_argument("--input", required=True, help=".shared input file")
    sp.add_argument("--circuit", required=True)
    sp.add_argument("--net-config", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_generate_witness)

    sp = sub.add_parser("translate-witness")
    sp.add_argument("--witness", required=True)
    sp.add_argument("--net-config", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_translate_witness)

    sp = sub.add_parser("generate-proof")
    sp.add_argument("--witness", required=True, help=".shared witness file")
    sp.add_argument("--circuit", required=True)
    sp.add_argument("--net-config", required=True)
    _crs_args(sp)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_generate_proof)

    sp = sub.add_parser("create-vk")
    sp.add_argument("--circuit", required=True)
    _crs_args(sp)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_create_vk)

    sp = sub.add_parser("verify")
    sp.add_argument("--proof", required=True)
    sp.add_argument("--vk", required=True)
    sp.set_defaults(fn=cmd_verify)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
