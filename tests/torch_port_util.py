"""Shared helpers of the tests that hold the PyTorch port to the JAX package.

Inputs are made from a seed with numpy and handed to both sides; the port
runs with device="cpu" on its plain versions; results are compared with
tolerance 0 (exact integer arithmetic), points by affine decode.
"""

import dataclasses

import numpy as np
import torch

from cocircom_tpu_torch import convert

# The plain versions are thousands of small tensor ops: more intra-op threads
# do not help them, and the test run has several worker processes already.
torch.set_num_threads(2)


PARTY_SEEDS = [bytes([i + 1]) * 32 for i in range(3)]


def pin_rep3_seeds(monkeypatch, *modules):
    """Party i's REP3 driver draws PARTY_SEEDS[i] as its PRF seed in every
    module named: parties construct their drivers in any order, so the
    seed is chosen by the calling thread's name (see `run_named`)."""
    import threading

    def pinned():
        return PARTY_SEEDS[int(threading.current_thread().name.split("-")[-1])]

    for m in modules:
        monkeypatch.setattr(m, "fresh_seed", pinned)


def run_named(run, fn, n: int = 3):
    """Run fn under the runner `run`, naming each party thread party-<i>."""
    import threading

    def wrapped(i, net):
        threading.current_thread().name = f"party-{i}"
        return fn(i, net)

    return run(wrapped, n)


def rand_ints(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]


def to_port(limbs16) -> torch.Tensor:
    """reference limb array (jax or numpy) -> port tensor on the CPU."""
    return convert.field_from_reference(np.asarray(limbs16), device="cpu")


def same(port_tensor: torch.Tensor, ref_limbs16) -> bool:
    """Equal after the limb repack, bit for bit."""
    return np.array_equal(convert.field_to_reference(port_tensor),
                          np.asarray(ref_limbs16))


def multiplier_chain(curve, r1cs_cls, n_mul: int, a_val: int):
    """R1CS of y = a^(n_mul+1) as a chain of multiplications.  Wires: 0 = 1,
    1 = y (public output), 2 = a (public input), 3.. = intermediates.
    Returns (r1cs, witness values as ints)."""
    p = curve.fr.p
    vals = [1, None, a_val % p]
    cons = []
    cur = 2
    for i in range(n_mul):
        out = 1 if i == n_mul - 1 else len(vals)
        cons.append(([(cur, 1)], [(2, 1)], [(out, 1)]))
        v = vals[cur] * vals[2] % p
        if out == 1:
            vals[1] = v
        else:
            vals.append(v)
        cur = out
    r1cs = r1cs_cls(curve=curve, n_wires=len(vals), n_pub_out=1, n_pub_in=1, n_prv_in=0,
                    n_labels=len(vals), n_constraints=len(cons), constraints=cons,
                    wire_mapping=[])
    return r1cs, vals


def small_msm_engines(monkeypatch):
    """Rank split T = 2 for the engines both packages create during one
    test (fewer idle lanes at toy sizes); cached engines are dropped before
    and after so no other test sees them."""
    import cocircom_tpu.ops.msm as ref_msm
    import cocircom_tpu_torch.ops.msm as port_msm

    monkeypatch.setenv("COCIRCOM_MSM_T", "2")          # read by the JAX package
    monkeypatch.setattr(port_msm.MSM, "T_DEFAULT", 2)
    ref_msm.msm_engine.cache_clear()
    port_msm.msm_engine.cache_clear()

    def restore():
        ref_msm.msm_engine.cache_clear()
        port_msm.msm_engine.cache_clear()

    return restore


def plonk_chain(curve, r1cs_cls, n_mul: int, a_val: int):
    """`multiplier_chain` plus one constraint (a + x3 + x4) * 1 = s with s a
    new wire: PLONK's setup turns its three-term side into two additions,
    the second reading the first.  Returns (r1cs, witness values as ints)."""
    r1cs, vals = multiplier_chain(curve, r1cs_cls, n_mul, a_val)
    s = len(vals)
    vals = vals + [(vals[2] + vals[3] + vals[4]) % curve.fr.p]
    cons = list(r1cs.constraints) + [([(2, 1), (3, 1), (4, 1)], [(0, 1)], [(s, 1)])]
    return dataclasses.replace(r1cs, n_wires=len(vals), n_labels=len(vals),
                               n_constraints=len(cons), constraints=cons), vals


def run_tcp(fn, n: int = 3, tls=None, timeout: float = 300.0) -> list:
    """fn(party_id, net) in n threads named party-<i>, each over its own
    `TcpNetwork` on localhost with device="cpu" (tls: a list of n TlsConfig
    or None); returns the results and raises the first error.  A party's
    network is closed when it ends, so a failed party ends its peers'
    receives too."""
    import threading

    from chip_smoke import free_ports
    from cocircom_tpu_torch.mpc.net import TcpNetwork

    addrs = [("127.0.0.1", p) for p in free_ports(n)]
    results, errors = [None] * n, [None] * n

    def party(i):
        try:
            net = TcpNetwork(i, addrs, tls=None if tls is None else tls[i], device="cpu")
            try:
                results[i] = fn(i, net)
            finally:
                net.close()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    threads = [threading.Thread(target=party, args=(i,), name=f"party-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a party thread did not finish"
    failed = [(i, e) for i, e in enumerate(errors) if e is not None]
    if failed:
        # a party's error often only ends its peers' receives: name them all
        first = failed[0][1]
        for i, e in failed[1:]:
            first.add_note(f"party {i} failed too: {e!r}")
        raise first
    return results


# ------------------------------------------------------------ noir fixtures
# ACIR programs built in code (the noir compiler is not available here).
# `acir_program_json` is the inverse of `noir/acir.py:parse_program`; it
# lives here, not in either package, because neither package writes ACIR.

def _acir_field(v: int) -> bytes:
    import struct

    h = f"{int(v):064x}".encode()
    return struct.pack("<Q", len(h)) + h


def _acir_expr(e) -> bytes:
    import struct

    out = [struct.pack("<Q", len(e.mul_terms))]
    for c, wl, wr in e.mul_terms:
        out.append(_acir_field(c) + struct.pack("<II", wl, wr))
    out.append(struct.pack("<Q", len(e.linear)))
    for c, w in e.linear:
        out.append(_acir_field(c) + struct.pack("<I", w))
    out.append(_acir_field(e.q_c))
    return b"".join(out)


def acir_program_bytes(circuits) -> bytes:
    """bincode(Program) of circuits (acir 0.49 layout, no Brillig)."""
    import struct

    out = [struct.pack("<Q", len(circuits))]
    for c in circuits:
        out.append(struct.pack("<IQ", c.current_witness_index, len(c.opcodes)))
        for op in c.opcodes:
            if op.kind == "assert_zero":
                out.append(struct.pack("<I", 0) + _acir_expr(op.expr))
            elif op.kind == "memory_op":
                out.append(struct.pack("<II", 3, op.block_id))
                out += [_acir_expr(op.mem.operation), _acir_expr(op.mem.index),
                        _acir_expr(op.mem.value)]
                out.append(b"\x00" if op.predicate is None
                           else b"\x01" + _acir_expr(op.predicate))
            elif op.kind == "memory_init":
                out.append(struct.pack("<IIQ", 4, op.block_id, len(op.init)))
                out.append(struct.pack(f"<{len(op.init)}I", *op.init))
                out.append(struct.pack("<I", op.block_type))
            else:
                raise ValueError(op.kind)
        if c.expression_width:
            out.append(struct.pack("<IQ", 1, c.expression_width))
        else:
            out.append(struct.pack("<I", 0))
        for ws in (c.private_parameters, c.public_parameters, c.return_values):
            out.append(struct.pack(f"<Q{len(ws)}I", len(ws), *ws))
        out.append(struct.pack("<QB", 0, int(c.recursive)))
    out.append(struct.pack("<Q", 0))
    return b"".join(out)


def acir_program_json(circuit, abi: dict | None = None) -> str:
    """A noir artifact JSON ({"bytecode", "abi"}) holding one circuit."""
    import base64
    import gzip
    import json

    raw = gzip.compress(acir_program_bytes([circuit]), mtime=0)
    return json.dumps({"bytecode": base64.b64encode(raw).decode(),
                       "abi": abi or {"parameters": []}})


def _abi_fields(names):
    return {"parameters": [{"name": nm, "type": {"kind": "field"}} for nm in names]}


def _circuit(acir, n_wit, opcodes, private, public, returns):
    return acir.Circuit(current_witness_index=n_wit - 1, opcodes=opcodes,
                        expression_width=4, private_parameters=private,
                        public_parameters=public, return_values=returns,
                        recursive=False)


def squaring_chain(n_ops: int, seed: int):
    """Opcode i asserts w_i * w_i + 7 - w_{i+1} = 0.  w_0 is a public
    parameter, w_{n_ops} the return value.  Returns (circuit, abi,
    witness ints, inputs ints)."""
    from cocircom_tpu_torch.fields.params import BN254
    from cocircom_tpu_torch.noir import acir

    p = BN254.fr.p
    w = [rand_ints(p, 1, seed)[0]]
    ops = []
    for i in range(n_ops):
        w.append((w[i] * w[i] + 7) % p)
        ops.append(acir.Opcode("assert_zero", expr=acir.Expression(
            [(1, i, i)], [(p - 1, i + 1)], 7)))
    c = _circuit(acir, n_ops + 1, ops, [], [0], [n_ops])
    return c, _abi_fields(["x"]), w, w[:1]


def poseidon_chain(n_rounds: int, seed: int):
    """A Poseidon-style arithmetized permutation chain over a width-4
    state: each round is an x^5 S-box on every lane (three multiply gates:
    x^2, x^4, x^5) and a width-4 linear layer (one quad gate a lane:
    y_j = c_j + c_{j+1} + 2 c_{j+2} + rc_j), 16 assert_zero opcodes a round.
    State lane 0 is a public parameter, lanes 1-3 private ones; the final
    lane 0 is the return value.  Round constants from the seed.  Returns
    (circuit, abi, witness ints, inputs ints)."""
    from cocircom_tpu_torch.fields.params import BN254
    from cocircom_tpu_torch.noir import acir

    p = BN254.fr.p
    E = acir.Expression
    rng = np.random.default_rng(seed)
    state = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(4)]
    w = list(state)
    lanes = [0, 1, 2, 3]
    ops = []

    def new(v):
        w.append(v % p)
        return len(w) - 1

    for _ in range(n_rounds):
        rc = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(4)]
        c5 = []
        for j in range(4):
            s = lanes[j]
            a = new(w[s] * w[s])
            ops.append(acir.Opcode("assert_zero", expr=E([(1, s, s)], [(p - 1, a)], 0)))
            b = new(w[a] * w[a])
            ops.append(acir.Opcode("assert_zero", expr=E([(1, a, a)], [(p - 1, b)], 0)))
            c = new(w[b] * w[s])
            ops.append(acir.Opcode("assert_zero", expr=E([(1, b, s)], [(p - 1, c)], 0)))
            c5.append(c)
        out = []
        for j in range(4):
            x0, x1, x2 = c5[j], c5[(j + 1) % 4], c5[(j + 2) % 4]
            y = new(w[x0] + w[x1] + 2 * w[x2] + rc[j])
            ops.append(acir.Opcode("assert_zero", expr=E(
                [], [(1, x0), (1, x1), (2, x2), (p - 1, y)], rc[j])))
            out.append(y)
        lanes = out
    c = _circuit(acir, len(w), ops, [1, 2, 3], [0], [lanes[0]])
    return c, _abi_fields(["s0", "s1", "s2", "s3"]), w, state


def memory_circuit(seed: int):
    """A ROM block read at a private index and a RAM block written and
    read at private indices.  Parameters: w0 = i (ROM and RAM read index),
    w1 = j (RAM write index), w2 = v (written value), w3 = x (public).
    Table cells w4..w7 = x + 1, x^2, 3x, x + 5 (solved); w8 = ROM[i];
    RAM: write RAM[j] = v, then w9 = RAM[i]; w10 = w8 * w9 (returned).
    Returns (circuit, abi, witness ints, inputs ints)."""
    from cocircom_tpu_torch.fields.params import BN254
    from cocircom_tpu_torch.noir import acir

    p = BN254.fr.p
    E = acir.Expression
    rng = np.random.default_rng(seed)
    i, j = int(rng.integers(0, 4)), int(rng.integers(0, 4))
    v, x = rand_ints(p, 2, seed + 1)
    cells = [(x + 1) % p, x * x % p, 3 * x % p, (x + 5) % p]
    ram = list(cells)
    ram[j] = v
    w = [i, j, v, x] + cells + [cells[i], ram[i]]
    w.append(w[8] * w[9] % p)
    ops = [
        acir.Opcode("assert_zero", expr=E([], [(1, 3), (p - 1, 4)], 1)),
        acir.Opcode("assert_zero", expr=E([(1, 3, 3)], [(p - 1, 5)], 0)),
        acir.Opcode("assert_zero", expr=E([], [(3, 3), (p - 1, 6)], 0)),
        acir.Opcode("assert_zero", expr=E([], [(1, 3), (p - 1, 7)], 5)),
        acir.Opcode("memory_init", block_id=0, init=[4, 5, 6, 7]),
        acir.Opcode("memory_op", block_id=0, mem=acir.MemOp(
            E([], [], 0), E([], [(1, 0)], 0), E([], [(1, 8)], 0))),
        acir.Opcode("memory_init", block_id=1, init=[4, 5, 6, 7]),
        acir.Opcode("memory_op", block_id=1, mem=acir.MemOp(
            E([], [], 1), E([], [(1, 1)], 0), E([], [(1, 2)], 0))),
        acir.Opcode("memory_op", block_id=1, mem=acir.MemOp(
            E([], [], 0), E([], [(1, 0)], 0), E([], [(1, 9)], 0))),
        acir.Opcode("assert_zero", expr=E([(1, 8, 9)], [(p - 1, 10)], 0)),
    ]
    c = _circuit(acir, len(w), ops, [0, 1, 2], [3], [10])
    return c, _abi_fields(["i", "j", "v", "x"]), w, [i, j, v, x]
