# Frozen copy of cocircom_tpu_torch/noir/acir.py (commit e513b03), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""ACIR artifact ingestion: noir program JSON -> opcodes, witness stacks.

The noir compiler (v0.33 / acir 0.49, the snapshot the reference pins in
upstream Cargo.toml:31-55) emits a JSON artifact whose `bytecode`
is base64(gzip(bincode(Program))). bincode 1.x fixint little-endian:
u64 lengths, u32 enum tags, field elements as 64-char hex strings.
The layout here was verified byte-for-byte against every committed KAT in
upstream test_vectors/noir/*/kat/*.json.

Opcode coverage mirrors the reference exactly: AssertZero, MemoryOp,
MemoryInit are handled; every other opcode is rejected at parse time
(upstream co-noir/co-acvm/src/solver.rs:296-312 `todo!`s the rest).
"""

from __future__ import annotations

import base64
import gzip
import json
import struct
from dataclasses import dataclass, field


@dataclass
class Expression:
    """Sum of mul terms (q*w_l*w_r), linear terms (q*w), and a constant.
    Parity: acir Expression<F>."""

    mul_terms: list  # [(coeff:int, w_l:int, w_r:int)]
    linear: list  # [(coeff:int, w:int)]
    q_c: int

    def is_const(self) -> bool:
        return not self.mul_terms and not self.linear


@dataclass
class MemOp:
    """operation: 0 = read, 1 = write (as a constant expression)."""

    operation: Expression
    index: Expression
    value: Expression


@dataclass
class Opcode:
    kind: str  # "assert_zero" | "memory_init" | "memory_op"
    expr: Expression | None = None
    block_id: int = 0
    init: list = field(default_factory=list)  # witnesses (memory_init)
    mem: MemOp | None = None
    predicate: Expression | None = None
    block_type: int = 0


@dataclass
class Circuit:
    current_witness_index: int
    opcodes: list
    expression_width: int  # 0 = unbounded, else the bound (4 for UltraHonk)
    private_parameters: list
    public_parameters: list
    return_values: list
    recursive: bool

    @property
    def public_inputs(self) -> list:
        """public parameters then return values, the Barretenberg order
        (ultrahonk/src/parse/acir_format.rs public_inputs handling)."""
        return list(self.public_parameters) + list(self.return_values)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n):
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated ACIR stream")
        self.pos += n
        return b

    def u8(self):
        return self.take(1)[0]

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def field(self) -> int:
        n = self.u64()
        s = self.take(n)
        return int(s, 16) if n else 0

    def expr(self) -> Expression:
        mul = [
            (self.field(), self.u32(), self.u32()) for _ in range(self.u64())
        ]
        lin = [(self.field(), self.u32()) for _ in range(self.u64())]
        return Expression(mul, lin, self.field())

    def opt_expr(self) -> Expression | None:
        return self.expr() if self.u8() else None


# acir 0.49 Opcode variant tags (verified against the committed KATs)
_TAG_ASSERT_ZERO = 0
_TAG_MEMORY_OP = 3
_TAG_MEMORY_INIT = 4


def parse_program(data: bytes) -> list[Circuit]:
    """bincode(Program) bytes -> circuits (functions)."""
    r = _Reader(data)
    circuits = []
    for _ in range(r.u64()):
        cwi = r.u32()
        n_ops = r.u64()
        ops = []
        for _ in range(n_ops):
            tag = r.u32()
            if tag == _TAG_ASSERT_ZERO:
                ops.append(Opcode("assert_zero", expr=r.expr()))
            elif tag == _TAG_MEMORY_OP:
                block = r.u32()
                mem = MemOp(r.expr(), r.expr(), r.expr())
                pred = r.opt_expr()
                ops.append(
                    Opcode("memory_op", block_id=block, mem=mem, predicate=pred)
                )
            elif tag == _TAG_MEMORY_INIT:
                block = r.u32()
                init = [r.u32() for _ in range(r.u64())]
                btype = r.u32()
                ops.append(
                    Opcode(
                        "memory_init",
                        block_id=block,
                        init=init,
                        block_type=btype,
                    )
                )
            else:
                raise NotImplementedError(
                    f"ACIR opcode tag {tag} (BlackBox/Brillig/Call) is "
                    "unsupported — reference parity: co-acvm solver.rs:312"
                )
        width_tag = r.u32()
        width = r.u64() if width_tag == 1 else 0
        priv = [r.u32() for _ in range(r.u64())]
        pub = [r.u32() for _ in range(r.u64())]
        ret = [r.u32() for _ in range(r.u64())]
        n_msgs = r.u64()
        if n_msgs:
            raise NotImplementedError("assert_messages parsing")
        recursive = bool(r.u8())
        circuits.append(Circuit(cwi, ops, width, priv, pub, ret, recursive))
    n_unconstrained = r.u64()
    if n_unconstrained:
        raise NotImplementedError("unconstrained (Brillig) functions")
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after ACIR program")
    return circuits


def load_program_json(path_or_data) -> tuple[list[Circuit], dict]:
    """noir artifact JSON -> (circuits, abi dict)."""
    if isinstance(path_or_data, (bytes, str)) and not str(path_or_data).lstrip().startswith("{"):
        d = json.load(open(path_or_data))
    else:
        d = (
            json.loads(path_or_data)
            if isinstance(path_or_data, (str, bytes))
            else path_or_data
        )
    raw = gzip.decompress(base64.b64decode(d["bytecode"]))
    return parse_program(raw), d.get("abi", {})


# ------------------------------------------------------- witness stacks


def parse_witness_stack(gz_data: bytes) -> list[tuple[int, dict]]:
    """<name>.gz -> [(function index, {witness: value})]. Format:
    bincode(WitnessStack) gzipped (verified vs kat/poseidon.gz)."""
    r = _Reader(gzip.decompress(gz_data))
    out = []
    for _ in range(r.u64()):
        idx = r.u32()
        wmap = {}
        for _ in range(r.u64()):
            w = r.u32()
            wmap[w] = r.field()
        out.append((idx, wmap))
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after witness stack")
    return out


def write_witness_stack(stack: list[tuple[int, dict]]) -> bytes:
    out = [struct.pack("<Q", len(stack))]
    for idx, wmap in stack:
        out.append(struct.pack("<IQ", idx, len(wmap)))
        for w in sorted(wmap):
            h = f"{wmap[w]:064x}".encode()
            out.append(struct.pack("<IQ", w, len(h)) + h)
    return gzip.compress(b"".join(out), mtime=0)
