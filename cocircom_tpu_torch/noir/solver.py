"""ACVM witness extension, generic over a noir-driver.

Parity: upstream co-noir/co-acvm/src/solver.rs (CoSolver::solve
:296, open_results :275), solver/assert_zero_solver.rs (simplify_expression
:84, solve_assert_zero :106), solver/memory_solver.rs (init :18, op :46).

Values are AcvmType = public int | driver share handle; the plain driver
(ground truth) works on host ints mod p. Opcode order is the solve order:
each AssertZero determines at most one new witness; memory ops run against
per-block LUTs (public index -> direct access; shared index -> the
driver's LUT provider, rep3/lut.rs equivalent).
"""

from __future__ import annotations

from .acir import Circuit, Expression


class Shared:
    """Marker wrapper for a driver share living in the witness map."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __repr__(self):
        return "Shared(...)"


def is_shared(x) -> bool:
    return isinstance(x, Shared)


class PlainNoirDriver:
    """Host-int ground truth (reference: PlainAcvmSolver semantics)."""

    protocol = "plain"

    def __init__(self, p: int):
        self.p = p

    def mul_public(self, c: int, x):
        return c * x % self.p

    def mul(self, x, y):
        return x * y % self.p

    def add(self, x, y):
        return (x + y) % self.p

    def solve_equation(self, q_l, c):
        """-c / q_l (both may be 'shared'; here plain ints)."""
        return (-c) * pow(q_l, -1, self.p) % self.p

    def init_lut(self, values: list):
        return list(values)

    def read_lut(self, index, lut):
        return lut[int(index)]

    def write_lut(self, index, value, lut):
        lut[int(index)] = value

    def open_many(self, shares: list) -> list:
        return shares


class AcvmSolver:
    def __init__(self, driver, circuit: Circuit):
        self.d = driver
        self.c = circuit
        self.witness: dict = {}
        self.memory: dict = {}

    # ------------------------------------------------------ expression eval

    def _simplify(self, expr: Expression):
        """Partial-evaluate an ACIR expression against known witnesses.
        Returns (constant_acc, remaining_linear[(coeff, w)]) where coeff can
        be shared when a mul term had one shared known side."""
        d = self.d
        acc = 0
        linear: list = []
        for c, wl, wr in expr.mul_terms:
            if c % d.p == 0:
                continue
            vl = self.witness.get(wl)
            vr = self.witness.get(wr)
            if vl is not None and vr is not None:
                if is_shared(vl) and is_shared(vr):
                    prod = Shared(d.mul(vl.v, vr.v))
                elif is_shared(vl):
                    prod = Shared(d.mul_public(vr, vl.v))
                elif is_shared(vr):
                    prod = Shared(d.mul_public(vl, vr.v))
                else:
                    prod = vl * vr % d.p
                acc = self._add(acc, self._mul_pub(c, prod))
            elif vl is not None:
                linear.append((self._mul_pub(c, vl), wr))
            elif vr is not None:
                linear.append((self._mul_pub(c, vr), wl))
            else:
                raise ValueError("two unknowns in mul term — not solvable")
        for q, w in expr.linear:
            v = self.witness.get(w)
            if v is not None:
                acc = self._add(acc, self._mul_pub(q, v))
            else:
                linear.append((q % d.p, w))
        acc = self._add(acc, expr.q_c % d.p)
        return acc, linear

    def _mul_pub(self, c: int, v):
        if is_shared(v):
            return Shared(self.d.mul_public(c % self.d.p, v.v))
        return c * v % self.d.p

    def _add(self, a, b):
        if is_shared(a) or is_shared(b):
            av = a.v if is_shared(a) else self.d.promote(a)
            bv = b.v if is_shared(b) else self.d.promote(b)
            return Shared(self.d.add(av, bv))
        return (a + b) % self.d.p

    def evaluate(self, expr: Expression):
        """Fully evaluate (no unknowns allowed)."""
        acc, linear = self._simplify(expr)
        if linear:
            raise ValueError("expression not fully determined")
        return acc

    # ------------------------------------------------------------- opcodes

    def _solve_assert_zero(self, expr: Expression):
        acc, linear = self._simplify(expr)
        if not linear:
            return
        if len(linear) > 1:
            raise ValueError("too many unknowns — not solvable")
        (q_l, w) = linear[0]
        d = self.d
        if is_shared(q_l) or is_shared(acc):
            ql = q_l.v if is_shared(q_l) else d.promote(q_l)
            c = acc.v if is_shared(acc) else d.promote(acc)
            self.witness[w] = Shared(d.solve_equation_shared(ql, c))
        else:
            self.witness[w] = d.solve_equation(q_l, acc)

    def _solve_memory_init(self, op):
        if op.block_id in self.memory:
            raise ValueError(f"duplicate memory block {op.block_id}")
        vals = []
        for w in op.init:
            v = self.witness.get(w)
            if v is None:
                raise ValueError("uninitialized witness written to memory")
            vals.append(v)
        self.memory[op.block_id] = self.d.init_lut(vals)

    def _solve_memory_op(self, op):
        d = self.d
        index = self.evaluate(op.mem.index)
        pred = self.evaluate(op.predicate) if op.predicate else None
        if pred is not None and is_shared(pred):
            raise ValueError("memory-op predicate must be public")
        rw = op.mem.operation.q_c
        lut = self.memory.get(op.block_id)
        if lut is None:
            raise ValueError(f"memory block {op.block_id} not initialized")
        if rw == 0:
            # read: value must be exactly one unknown witness w/ coeff 1
            acc, linear = self._simplify(op.mem.value)
            if (
                len(linear) != 1
                or is_shared(linear[0][0])
                or linear[0][0] != 1
                or is_shared(acc)
                or acc != 0
            ):
                raise ValueError("mem read value must be a bare witness")
            w = linear[0][1]
            if pred == 0:
                self.witness[w] = 0
            else:
                self.witness[w] = d.read_lut(index, lut)
        elif rw == 1:
            value = self.evaluate(op.mem.value)
            if pred != 0:
                d.write_lut(index, value, lut)
        else:
            raise ValueError(f"unknown memory operation {rw}")

    # -------------------------------------------------------------- driver

    def bind_inputs(self, values: list):
        """values: AcvmTypes for witnesses 0..len-1 (the ABI parameter
        flattening assigns the first witnesses in parameter order)."""
        for i, v in enumerate(values):
            self.witness[i] = v if is_shared(v) else v % self.d.p

    def solve(self) -> dict:
        """Run all opcodes; open return values; return the witness map."""
        for op in self.c.opcodes:
            if op.kind == "assert_zero":
                self._solve_assert_zero(op.expr)
            elif op.kind == "memory_init":
                self._solve_memory_init(op)
            elif op.kind == "memory_op":
                self._solve_memory_op(op)
            else:  # pragma: no cover — parse already rejects
                raise NotImplementedError(op.kind)
        # open return values (solver.rs:275 open_results)
        shared_rets = [
            self.witness[w].v
            for w in self.c.return_values
            if is_shared(self.witness.get(w))
        ]
        if shared_rets:
            opened = self.d.open_many(shared_rets)
            it = iter(opened)
            for w in self.c.return_values:
                if is_shared(self.witness.get(w)):
                    self.witness[w] = next(it)
        return self.witness


# --------------------------------------------------------- input binding


def flatten_abi_value(v, typ: dict, p: int) -> list[int]:
    kind = typ.get("kind")
    if kind in ("field", "integer", "boolean"):
        return [_parse_scalar(v, p)]
    if kind == "array":
        inner = typ["type"]
        out = []
        for e in v:
            out.extend(flatten_abi_value(e, inner, p))
        return out
    if kind == "struct":
        out = []
        for f in typ["fields"]:
            out.extend(flatten_abi_value(v[f["name"]], f["type"], p))
        return out
    if kind == "string":
        return [ord(ch) for ch in v]
    raise NotImplementedError(f"abi kind {kind}")


def _parse_scalar(v, p: int) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v % p
    s = str(v).strip()
    return (int(s, 16) if s.startswith("0x") else int(s)) % p


def bind_toml_inputs(abi: dict, inputs: dict, p: int) -> list[int]:
    """ABI parameters + Prover.toml dict -> witness values 0..n (parity:
    solver.rs:78-131 partial ABI witness construction)."""
    out = []
    for param in abi.get("parameters", []):
        name = param["name"]
        if name not in inputs:
            raise KeyError(f"missing input {name!r}")
        out.extend(flatten_abi_value(inputs[name], param["type"], p))
    return out
