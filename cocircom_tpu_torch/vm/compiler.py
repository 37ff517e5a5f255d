"""circom frontend: elaboration to a leveled witness-extension op tape.

Vectorized design (NOT the upstream project's stack bytecode): since valid circom
control flow is compile-time (vars/params only), the whole circuit is
elaborated eagerly into an SSA op tape over symbolic signals; the tape is
topologically sorted into LEVELS — the natural unit for batching secret-
shared ops into single communication rounds (the role of the reference's
circom-mpc-vm, SURVEY.md L4, re-designed for vectorized execution).

Signal/witness layout parity with circom (validated against the committed
KAT witnesses of the upstream test_vectors/WitnessExtension/kats):
  [1 | main outputs | main inputs | main intermediates | subcomponent
   signals depth-first in instantiation order]; a signal assigned from
  exactly another signal is wire-aliased (no witness slot) unless both
  are main signals.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..fields.params import CurveParams
from . import algebra as alg
from .parser import parse_circom


class Sig:
    __slots__ = ("uid",)
    _next = [0]

    def __init__(self):
        self.uid = Sig._next[0]
        Sig._next[0] += 1

    def __repr__(self):
        return f"Sig({self.uid})"


class Temp:
    __slots__ = ("tid",)

    def __init__(self, tid):
        self.tid = tid

    def __repr__(self):
        return f"Temp({self.tid})"


@dataclass
class Component:
    template: str
    outs: list = field(default_factory=list)  # [(name, [Sig...], dims)]
    ins: list = field(default_factory=list)
    inters: list = field(default_factory=list)
    subs: list = field(default_factory=list)  # [Component] instantiation order
    # component VAR declarations in declaration order: (name, env) — env is
    # held by reference so array slots filled later are visible (drives the
    # label-order walk in compile_circom)
    comp_vars: list = field(default_factory=list)
    sig_by_name: dict = field(default_factory=dict)  # name -> (kind, flat list, dims)
    # --- circom execution-order modelling (witness layout, see compile) ---
    args: tuple = ()  # template arguments (node identity: (template, args))
    n_input_sigs: int = 0
    local_events: list = field(default_factory=list)  # ("create"|"input", Component)


@dataclass
class CompiledCircuit:
    curve: CurveParams
    n_signals: int  # witness slots excluding the leading 1
    n_outputs: int
    input_slots: dict  # name -> list of slot indices (1-based wtns index)
    output_slots: dict
    public_names: list
    levels: list  # list of [ (op, dst, operands) ]; operand = ('c',v)|('w',slot)|('t',tid)
    n_temps: int

    @property
    def n_vars(self):
        return self.n_signals + 1


class LayoutReconcileError(ValueError):
    """A forced kept-label set could not be realized by the simplifier.

    stuck_positions: 0-based positions (in the full label order) of the
    signals the simplifier refused to eliminate — callers fitting a layout
    from a sample witness (vm/fit_layout.py) use them as mandatory anchors
    for a refit."""

    def __init__(self, msg, stuck_positions=()):
        super().__init__(msg)
        self.stuck_positions = tuple(stuck_positions)


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class Elaborator:
    def __init__(self, templates, functions, p: int):
        self.templates = templates
        self.functions = functions
        self.p = p
        self.ops = []  # (op, dst(Sig|Temp), [operands: int|Sig|Temp])
        self.n_temps = 0
        self.temp_deg: list[int] = []  # polynomial degree per temp (2 = nonlin)
        self.temp_alg: list = []  # AExpr per temp (algebra.py) or None
        self.binding = {}  # uid -> value (Sig|Temp|int): aliased/eliminated
        self.constraints: list[alg.Constraint] = []  # R1CS, generation order
        self.pinned: set[int] = set()  # uids constrained non-algebraically
        self.sig_kind = {}  # uid -> "output"|"input"|"intermediate"
        self._created = []  # every Component in instantiation order
        self.root_comp = None  # the main component (its signals keep slots)
        self.sig_owner = {}  # uid -> Component
        # secret-condition branching state (parity: circom-mpc-vm
        # mpc_vm.rs:104-176 IfCtxStack + :649-754 shared function returns)
        self.cond_stack = []  # [(outer_acc|None, acc, cond)]
        self.fn_stack = []  # [{"rets": [(cond, val)], "entry": depth}]
        self.sig_val = {}  # uid -> last assigned value expr (for cmux merge)

    # ------------------------------------------------------- value helpers

    def resolve(self, v):
        """Follow signal bindings to the defining value."""
        while isinstance(v, Sig) and v.uid in self.binding:
            v = self.binding[v.uid]
        return v

    def _deg(self, v) -> int:
        if isinstance(v, int):
            return 0
        if isinstance(v, Sig):
            return 1
        return self.temp_deg[v.tid]

    def new_temp(self, deg: int = 2, ae=None) -> Temp:
        t = Temp(self.n_temps)
        self.n_temps += 1
        self.temp_deg.append(deg)
        self.temp_alg.append(ae)
        return t

    def alg_of(self, v):
        """AExpr view of a value (constraint algebra; None = degree > 2 or
        non-polynomial, only legal on the <-- path in vanilla circom)."""
        if isinstance(v, int):
            return alg.ae_const(v, self.p)
        if isinstance(v, Sig):
            return alg.ae_sig(v.uid)
        return self.temp_alg[v.tid]

    LINEAR_OPS = {"add", "sub", "neg", "sett", "setc"}

    def emit(self, op, operands) -> Temp:
        operands = [self.resolve(o) for o in operands]
        p = self.p
        ae = None
        if op in ("add", "sub"):
            deg = max(self._deg(o) for o in operands)
            f = alg.ae_add if op == "add" else alg.ae_sub
            ae = f(self.alg_of(operands[0]), self.alg_of(operands[1]), p)
        elif op == "neg":
            deg = self._deg(operands[0])
            ae = alg.ae_neg(self.alg_of(operands[0]), p)
        elif op == "mul":
            deg = min(2, sum(self._deg(o) for o in operands))
            ae = alg.ae_mul(self.alg_of(operands[0]), self.alg_of(operands[1]), p)
        elif op == "div":
            deg = self._deg(operands[0]) if self._deg(operands[1]) == 0 else 2
            ae = alg.ae_div(self.alg_of(operands[0]), self.alg_of(operands[1]), p)
        else:
            deg = 2
        dst = self.new_temp(deg, ae)
        self.ops.append((op, dst, operands))
        return dst

    def _val(self, x: int) -> int:
        x %= self.p
        return x - self.p if x > self.p // 2 else x

    def const_op2(self, op, a: int, b: int) -> int:
        """circom semantics on compile-time field elements (plain.rs parity)."""
        p = self.p
        a %= p
        b %= p
        if op == "+":
            return (a + b) % p
        if op == "-":
            return (a - b) % p
        if op == "*":
            return (a * b) % p
        if op == "/":
            return a * pow(b, -1, p) % p
        if op == "\\":
            return a // b
        if op == "%":
            return a % b
        if op == "**":
            return pow(a, b, p)
        if op == "<":
            return int(self._val(a) < self._val(b))
        if op == ">":
            return int(self._val(a) > self._val(b))
        if op == "<=":
            return int(self._val(a) <= self._val(b))
        if op == ">=":
            return int(self._val(a) >= self._val(b))
        if op == "==":
            return int(a == b)
        if op == "!=":
            return int(a != b)
        if op == "&&":
            return int(bool(a) and bool(b))
        if op == "||":
            return int(bool(a) or bool(b))
        if op == "&":
            return a & b
        if op == "|":
            return a | b
        if op == "^":
            return a ^ b
        if op == "<<":
            return (a << b) % p if b < 256 else 0
        if op == ">>":
            return a >> b if b < 256 else 0
        raise ValueError(f"unknown op {op}")

    BIN_OPNAME = {
        "+": "add", "-": "sub", "*": "mul", "/": "div", "\\": "idiv",
        "%": "mod", "**": "pow", "<": "lt", ">": "gt", "<=": "le",
        ">=": "ge", "==": "eq", "!=": "neq", "&&": "land", "||": "lor",
        "&": "band", "|": "bor", "^": "bxor", "<<": "shl", ">>": "shr",
    }

    def binop(self, op, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return self.const_op2(op, a, b)
        if op in ("/", "\\", "%") and self._secret():
            # guarded division under a secret/runtime condition: the untaken
            # branch still executes, so its denominator is replaced by 1
            # (parity: mpc_vm.rs:523-531 Div cmux guard)
            if isinstance(b, int):
                if b % self.p == 0:
                    b = 1
            else:
                b = self.emit("cmux", [self._acc_cond(), b, 1])
        return self.emit(self.BIN_OPNAME[op], [a, b])

    # ---- secret-condition contexts (mpc_vm.rs IfCtxStack parity) ----

    def _secret(self) -> bool:
        return bool(self.cond_stack)

    def _acc_cond(self):
        return self.cond_stack[-1][1]

    def _not(self, c):
        return self.binop("-", 1, c)

    def _push_cond(self, cond):
        outer = self.cond_stack[-1][1] if self.cond_stack else None
        acc = cond if outer is None else self.emit("mul", [outer, cond])
        self.cond_stack.append((outer, acc, cond))

    def _toggle_cond(self):
        outer, _, cond = self.cond_stack[-1]
        notc = self._not(cond)
        acc = notc if outer is None else self.emit("mul", [outer, notc])
        self.cond_stack[-1] = (outer, acc, cond)

    def _pop_cond(self):
        self.cond_stack.pop()

    def _merge_val(self, cond, new, old):
        """cmux(cond, new, old); recursive over arrays, zero-padded to the
        longer length (mpc_vm.rs:690-692 resize semantics)."""
        if isinstance(new, list) or isinstance(old, list):
            if not isinstance(new, list):
                new = [new]
            if not isinstance(old, list):
                old = [old]
            n = max(len(new), len(old))
            new = new + [0] * (n - len(new))
            old = old + [0] * (n - len(old))
            return [self._merge_val(cond, x, y) for x, y in zip(new, old)]
        new = self.resolve(new)
        old = self.resolve(old)
        if isinstance(new, int) and isinstance(old, int) and new % self.p == old % self.p:
            return new % self.p
        return self.emit("cmux", [cond, new, old])

    def _finish_fn(self, ctx, final_val):
        """Merge accumulated conditional returns: sum of cond_i * val_i,
        with the fall-through/unconditional value weighted by the product of
        negated prior conditions (mpc_vm.rs:784-808)."""
        rets = list(ctx["rets"])
        if not rets:
            return final_val
        conds = [c for c, _ in rets]
        vals = [v for _, v in rets]
        if final_val is not None:
            fc = None
            for c in conds:
                nc = self._not(c)
                fc = nc if fc is None else self.emit("mul", [fc, nc])
            conds.append(fc)
            vals.append(final_val)
        width = max((len(v) if isinstance(v, list) else 1) for v in vals)
        is_list = any(isinstance(v, list) for v in vals)

        def elem(v, i):
            if isinstance(v, list):
                return v[i] if i < len(v) else 0
            return v if i == 0 else 0

        out = []
        for i in range(width):
            acc = None
            for c, v in zip(conds, vals):
                term = self.binop("*", c, elem(v, i))
                acc = term if acc is None else self.binop("+", acc, term)
            out.append(acc)
        return out if is_list else out[0]

    def unop(self, op, a):
        if isinstance(a, int):
            if op == "-":
                return (-a) % self.p
            if op == "!":
                return int(not a)
            if op == "~":
                return (~a) % self.p
        name = {"-": "neg", "!": "lnot", "~": "bnot"}[op]
        return self.emit(name, [a])

    # ------------------------------------------------------- elaboration

    def instantiate(self, tmpl_name: str, args: list, parent=None) -> Component:
        params, body = self.templates[tmpl_name]
        if len(args) != len(params):
            raise ValueError(f"{tmpl_name} expects {len(params)} params")
        comp = Component(template=tmpl_name, args=tuple(repr(a) for a in args))
        if self.root_comp is None:
            self.root_comp = comp
        if parent is not None:
            parent.local_events.append(("create", comp))
        self._created.append(comp)
        env = {pn: av for pn, av in zip(params, args)}
        env["__comp__"] = comp
        self.exec_stmt(body, env, comp)
        return comp

    def call_function(self, name: str, args: list):
        # accelerator intrinsics (parity: accelerator.rs:17-68): circomlib's
        # Tonelli-Shanks `sqrt` has data-dependent loops, so a symbolic
        # argument routes to the sqrt op (host: Tonelli-Shanks; MPC: masked
        # open, rep3.rs:400)
        if name == "sqrt" and len(args) == 1 and not isinstance(args[0], int):
            return self.emit("sqrt", [args[0]])
        params, body = self.functions[name]
        env = {pn: av for pn, av in zip(params, args)}
        ctx = {"rets": [], "entry": len(self.cond_stack)}
        self.fn_stack.append(ctx)
        try:
            self.exec_stmt(body, env, None)
        except _Return as r:
            return self._finish_fn(ctx, r.value)
        finally:
            self.fn_stack.pop()
        if ctx["rets"]:
            return self._finish_fn(ctx, None)
        raise ValueError(f"function {name} did not return")

    # ---- lvalue resolution: returns (container, index) or signal handle ----

    def _flat_dims(self, dims, env, comp):
        out = []
        for dexpr in dims:
            v = self.eval(dexpr, env, comp)
            if not isinstance(v, int):
                raise ValueError("array dims must be compile-time")
            out.append(v)
        return out

    @staticmethod
    def _make_array(dims, make):
        if not dims:
            return make()
        return [Elaborator._make_array(dims[1:], make) for _ in range(dims[0])]

    @staticmethod
    def _flatten(x):
        if isinstance(x, list):
            out = []
            for e in x:
                out.extend(Elaborator._flatten(e))
            return out
        return [x]

    def exec_stmt(self, st, env, comp):
        tag = st[0]
        if tag == "block":
            for s in st[1]:
                self.exec_stmt(s, env, comp)
        elif tag == "decl_signal":
            _, kind, name, dims_e, init = st
            dims = self._flat_dims(dims_e, env, comp)
            arr = self._make_array(dims, Sig)
            flat = self._flatten(arr)
            bucket = {"output": comp.outs, "input": comp.ins, "intermediate": comp.inters}[kind]
            bucket.append((name, flat, dims))
            comp.sig_by_name[name] = (kind, arr)
            if kind == "input":
                comp.n_input_sigs += len(flat)
            for s in flat:
                self.sig_owner[s.uid] = comp
                self.sig_kind[s.uid] = kind
            env[name] = arr
            if init is not None:
                _op, expr = init
                self.assign_signal(
                    arr, self.eval(expr, env, comp), comp, constrained=_op == "<=="
                )
        elif tag == "decl_var":
            _, name, dims_e, init = st
            dims = self._flat_dims(dims_e, env, comp)
            if dims:
                env[name] = self._make_array(dims, lambda: 0)
            else:
                env[name] = 0
            if init is not None:
                env[name] = self.eval(init, env, comp)
        elif tag == "decl_comp":
            _, name, dims_e = st
            dims = self._flat_dims(dims_e, env, comp)
            env[name] = self._make_array(dims, lambda: None) if dims else None
            if comp is not None:
                comp.comp_vars.append((name, env))
        elif tag == "assign":
            _, op, lhs, rhs = st
            val = self.eval(rhs, env, comp)
            if op not in ("=", "<==", "<--") and op.endswith("="):
                cur = self.eval(lhs, env, comp)
                val = self.binop(op[:-1], cur, val)
                op = "="
            self.assign(lhs, op, val, env, comp)
        elif tag == "constraint":
            # `===`: no witness effect, but the constraint participates in
            # O2 simplification (e.g. BinSum's lin === lout eliminates a
            # carry bit). Evaluate both sides algebraically.
            _, le, re_ = st
            a = self.eval(le, env, comp)
            b = self.eval(re_, env, comp)
            self._record_eq(a, b)
        elif tag == "for":
            _, init, cond, step, body = st
            scope = dict(env)
            self.exec_stmt(init, scope, comp)
            while True:
                c = self.eval(cond, scope, comp)
                if not isinstance(c, int):
                    raise ValueError("loop condition must be compile-time")
                if not c:
                    break
                self.exec_stmt(body, scope, comp)
                self.exec_stmt(step, scope, comp)
            for k in env:
                if k in scope:
                    env[k] = scope[k]
        elif tag == "while":
            _, cond, body = st
            while True:
                c = self.eval(cond, env, comp)
                if not isinstance(c, int):
                    raise ValueError("loop condition must be compile-time")
                if not c:
                    break
                self.exec_stmt(body, env, comp)
        elif tag == "if":
            _, cond, then, els = st
            c = self.eval(cond, env, comp)
            if isinstance(c, int):
                if c:
                    self.exec_stmt(then, env, comp)
                elif els is not None:
                    self.exec_stmt(els, env, comp)
            else:
                # runtime/secret condition: execute BOTH branches; stores and
                # returns inside merge via cmux (mpc_vm.rs:471-506)
                self._push_cond(self.resolve(c))
                self.exec_stmt(then, env, comp)
                if els is not None:
                    self._toggle_cond()
                    self.exec_stmt(els, env, comp)
                self._pop_cond()
        elif tag == "return":
            val = self.eval(st[1], env, comp)
            if self.fn_stack and len(self.cond_stack) > self.fn_stack[-1]["entry"]:
                # conditional return: record (condition, value) and continue
                # executing — merged at function exit (mpc_vm.rs:649-713)
                ctx = self.fn_stack[-1]
                this = self._acc_cond()
                for pc, _ in ctx["rets"]:
                    this = self.binop("*", this, self._not(pc))
                ctx["rets"].append((this, val))
            else:
                raise _Return(val)
        elif tag == "assert":
            v = self.eval(st[1], env, comp)
            if not self._secret() and isinstance(v, int) and not v:
                raise AssertionError("circom assert failed at compile time")
        elif tag == "log":
            pass
        elif tag == "expr":
            self.eval(st[1], env, comp)
        else:
            raise ValueError(f"unhandled stmt {tag}")

    def assign(self, lhs, op, val, env, comp):
        # resolve lhs to var slot / signal / component field
        target = self._resolve_lvalue(lhs, env, comp)
        kind = target[0]
        if kind == "var":
            container, key = target[1], target[2]
            if self._secret():
                # store under a secret condition -> cmux with the old value
                # (mpc_vm.rs:312-352 store handling)
                container[key] = self._merge_val(self._acc_cond(), val, container[key])
            else:
                container[key] = val
        elif kind == "signal":
            self.assign_signal(target[1], val, comp, constrained=op != "<--")
        elif kind == "comp_slot":
            container, key = target[1], target[2]
            if op != "=":
                raise ValueError("components are assigned with =")
            container[key] = val
        else:
            raise ValueError(kind)

    def _resolve_lvalue(self, lhs, env, comp):
        tag = lhs[0]
        if tag == "var":
            name = lhs[1]
            if comp is not None and name in comp.sig_by_name:
                return ("signal", env[name])
            if name in env:
                cur = env[name]
                if isinstance(cur, Component) or cur is None:
                    return ("comp_slot", env, name)
                return ("var", env, name)
            env[name] = 0
            return ("var", env, name)
        if tag == "idx":
            base = self._resolve_lvalue(lhs[1], env, comp)
            idx = self.eval(lhs[2], env, comp)
            if not isinstance(idx, int):
                raise ValueError("index must be compile-time")
            if base[0] in ("var", "comp_slot"):
                container = base[1][base[2]]
                if isinstance(container, list):
                    if container and (container[0] is None or isinstance(container[0], (Component, list))):
                        # could be component array or nested arr
                        pass
                    return (
                        "comp_slot" if self._is_comp_arr(container) else "var",
                        container,
                        idx,
                    )
                raise ValueError("indexing non-array")
            if base[0] == "signal":
                return ("signal", base[1][idx])
            raise ValueError("bad index target")
        if tag == "mem":
            inst = self.eval(lhs[1], env, comp)
            if not isinstance(inst, Component):
                raise ValueError("member access on non-component")
            fname = lhs[2]
            kind, arr = inst.sig_by_name[fname]
            return ("signal", arr)
        raise ValueError(f"bad lvalue {tag}")

    @staticmethod
    def _is_comp_arr(container):
        probe = container
        while isinstance(probe, list) and probe:
            probe = probe[0]
        return probe is None or isinstance(probe, Component)

    def assign_signal(self, sig_or_arr, val, comp, constrained: bool = True):
        if isinstance(sig_or_arr, list):
            if not isinstance(val, list):
                raise ValueError("array signal assignment shape mismatch")
            if len(val) != len(sig_or_arr):
                # merged function returns may be longer (zero-padded union of
                # branch shapes): truncate/pad to the declared signal shape,
                # matching the reference's izip over the declared return size
                # (mpc_vm.rs:789-800)
                val = val[: len(sig_or_arr)] + [0] * (len(sig_or_arr) - len(val))
            for s, v in zip(sig_or_arr, val):
                self.assign_signal(s, v, comp, constrained)
            return
        sig = sig_or_arr
        val = self.resolve(val)
        if self._secret():
            val = self._merge_val(self._acc_cond(), val, self.sig_val.get(sig.uid, 0))
        self.sig_val[sig.uid] = val
        owner = self.sig_owner.get(sig.uid)
        if (
            comp is not None
            and owner is not None
            and owner is not comp
            and self.sig_kind.get(sig.uid) == "input"
        ):
            # wiring a subcomponent input: an execution event in the parent's
            # body (circom activates the child at its LAST input assignment —
            # this drives the witness block order, see compile_circom)
            comp.local_events.append(("input", owner))
        if constrained:
            # `<==` / `===` emit one R1CS constraint: val - sig == 0. Values
            # outside the degree<=2 algebra (comparisons on shares, secret-
            # condition merges) pin the signal into the witness instead.
            ae = alg.ae_sub(self.alg_of(val), alg.ae_sig(sig.uid), self.p)
            if ae is not None:
                self.constraints.append(alg.Constraint.from_ae(ae, self.p))
            else:
                self.pinned.add(sig.uid)
        if isinstance(val, int):
            self.ops.append(("setc", sig, [val % self.p]))
        else:
            self.ops.append(("sett", sig, [val]))

    def _record_eq(self, a, b):
        """Record a === b (elementwise over arrays)."""
        if isinstance(a, list) or isinstance(b, list):
            if not (isinstance(a, list) and isinstance(b, list)) or len(a) != len(b):
                raise ValueError("=== shape mismatch")
            for x, y in zip(a, b):
                self._record_eq(x, y)
            return
        ae = alg.ae_sub(self.alg_of(self.resolve(a)), self.alg_of(self.resolve(b)), self.p)
        if ae is not None:
            self.constraints.append(alg.Constraint.from_ae(ae, self.p))

    def eval(self, e, env, comp):
        tag = e[0]
        if tag == "num":
            v = e[1]
            return (int(v, 16) if v.startswith(("0x", "0X")) else int(v)) % self.p
        if tag == "arr":
            return [self.eval(x, env, comp) for x in e[1]]
        if tag == "str":
            return e[1]
        if tag == "var":
            name = e[1]
            if name in env:
                v = env[name]
                return v
            raise NameError(f"unknown identifier {name}")
        if tag == "idx":
            base = self.eval(e[1], env, comp)
            idx = self.eval(e[2], env, comp)
            if not isinstance(idx, int):
                raise ValueError("index must be compile-time")
            return base[idx]
        if tag == "mem":
            inst = self.eval(e[1], env, comp)
            if not isinstance(inst, Component):
                raise ValueError("member access on non-component")
            _kind, arr = inst.sig_by_name[e[2]]
            return arr
        if tag == "bin":
            _, op, l, r = e
            a = self.eval(l, env, comp)
            b = self.eval(r, env, comp)
            a = self._sigval(a)
            b = self._sigval(b)
            return self.binop(op, a, b)
        if tag == "un":
            return self.unop(e[1], self._sigval(self.eval(e[2], env, comp)))
        if tag == "tern":
            c = self.eval(e[1], env, comp)
            if isinstance(c, int):
                return self.eval(e[2] if c else e[3], env, comp)
            a = self.eval(e[2], env, comp)
            b = self.eval(e[3], env, comp)
            return self._merge_val(self.resolve(c), a, b)
        if tag == "call":
            name = e[1]
            args = [self.eval(a, env, comp) for a in e[2]]
            if name in self.templates:
                return self.instantiate(name, args, parent=comp)
            if name in self.functions:
                return self.call_function(name, args)
            raise NameError(f"unknown callable {name}")
        raise ValueError(f"unhandled expr {tag}")

    @staticmethod
    def _sigval(v):
        return v


def compile_circom(
    src: str,
    curve: CurveParams,
    link: list[str] | None = None,
    opt: int | None = None,
    keep_labels=None,
    n_labels: int | None = None,
) -> CompiledCircuit:
    """opt: simplification level (circom --O0/--O1/--O2); default --O2, the
    reference compiler's SimplificationLevel::O2(usize::MAX)
    (circom-mpc-compiler/src/lib.rs:56-58). Override with COCIRCOM_OPT.

    keep_labels: optional iterable of 1-based circom LABEL ids that must
    keep witness slots — pass an r1cs `wire_mapping[1:]` (io/r1cs.py;
    format: circom-types/src/r1cs.rs:75-104) to pin the witness layout to
    the exact kept-set circom chose when it produced that r1cs/zkey,
    sidestepping any divergence in the elimination-pivot heuristic."""
    if opt is None:
        opt = int(os.environ.get("COCIRCOM_OPT", "2"))
    link = link or []
    templates: dict = {}
    functions: dict = {}
    main = None
    seen = set()

    def load(text: str, base: str):
        nonlocal main
        includes, tpls, funcs, m = parse_circom(text)
        for inc in includes:
            path = None
            for d in [base] + link:
                cand = os.path.join(d, inc)
                if os.path.isfile(cand):
                    path = cand
                    break
            if path is None:
                raise FileNotFoundError(f"include {inc!r} not found")
            if path not in seen:
                seen.add(path)
                load(open(path).read(), os.path.dirname(path))
        templates.update(tpls)
        functions.update(funcs)
        if m is not None:
            main = m

    load(src, ".")
    if main is None:
        raise ValueError("no main component")
    (main_expr, publics) = main
    if main_expr[0] != "call":
        raise ValueError("main must instantiate a template")

    el = Elaborator(templates, functions, curve.fr.p)
    args = [el.eval(a, {}, None) for a in main_expr[2]]
    root = el.instantiate(main_expr[1], args)

    import sys

    sys.setrecursionlimit(1000000)

    # ---- circom execution replay: COMPLETION order. circom executes a
    # subcomponent when its LAST input is assigned (immediately, depth-
    # first); a node's rank is when its body finishes (post-order), which
    # differs from both declaration and activation order. The witness
    # layout below depends on it. ----
    act: dict[int, int] = {}  # id(comp) -> completion rank
    started: set[int] = set()
    need = {id(c): c.n_input_sigs for c in el._created}
    counter = [0]

    def execute(c: Component):
        started.add(id(c))
        for kind, k in c.local_events:
            if kind == "input":
                need[id(k)] -= 1
            if need[id(k)] == 0 and id(k) not in started:
                execute(k)
        act[id(c)] = counter[0]
        counter[0] += 1

    execute(root)
    for c in el._created:  # never-completed components: creation order
        if id(c) not in act:
            act[id(c)] = counter[0]
            counter[0] += 1

    # node identity: (template, args) — circom deduplicates equal template
    # instances into one DAG node; a node's rank is its FIRST activation
    node_rank: dict = {}
    for c in el._created:
        key = (c.template, c.args)
        r = act[id(c)]
        if key not in node_rank or r < node_rank[key]:
            node_rank[key] = r

    # ---- witness order = circom's LABEL order restricted to kept signals
    # (the r1cs wire2label maps are monotone — wire order IS label order;
    # upstream co-circom/circom-types/src/r1cs.rs:75-104). Label
    # order is a DFS over the component tree: each component's own signals
    # (outputs, inputs — public first at the root —, intermediates,
    # declaration order within each bucket), then its child instances
    # GROUPED BY TEMPLATE NAME (ascii-sorted, creation order within a
    # group), each child visited recursively. Fitted against the committed
    # poseidon r1cs label map + the 60 KAT witnesses; the elimination
    # choices below are positional in this same order. ----
    order: list[Sig] = []

    def visit_all(c: Component):
        ins = c.ins
        if c is root and publics:
            pub = [b for b in ins if b[0] in publics]
            priv = [b for b in ins if b[0] not in publics]
            ins = pub + priv
        for bucket in (c.outs, ins, c.inters):
            for _name, flat, _dims in bucket:
                order.extend(flat)

    layout = os.environ.get("COCIRCOM_LAYOUT", "label")
    if layout.startswith("label"):
        visited: set[int] = set()

        def children(c: Component) -> list[Component]:
            """Child instances: component vars (ascii-sorted names, array
            index order within a var), then any stragglers by creation."""
            cvars = list(c.comp_vars)
            if layout != "label_decl":
                cvars.sort(key=lambda nv: nv[0])
            out, seen = [], set()
            for name, env in cvars:
                for inst in Elaborator._flatten(env.get(name)):
                    if isinstance(inst, Component) and id(inst) not in seen:
                        seen.add(id(inst))
                        out.append(inst)
            for kind, k in c.local_events:
                if kind == "create" and id(k) not in seen:
                    seen.add(id(k))
                    out.append(k)
            return out

        def walk(c: Component):
            visited.add(id(c))
            visit_all(c)
            for s in children(c):
                if id(s) not in visited:
                    walk(s)

        walk(root)
        for c in el._created:  # components with no recorded parent
            if id(c) not in visited:
                walk(c)
    else:  # "completion": the round-2 replay rule, kept for comparison
        visit_all(root)
        others = [c for c in el._created if c is not root]
        others.sort(
            key=lambda c: (-node_rank[(c.template, c.args)], act[id(c)])
        )
        for c in others:
            visit_all(c)
    pos = {s.uid: i for i, s in enumerate(order)}

    # ---- O2 constraint simplification -> kept signal set ----
    forbidden: set[int] = set()
    for _n, flat, _d in root.outs:
        forbidden.update(s.uid for s in flat)
    for name, flat, _d in root.ins:
        if name in publics:
            forbidden.update(s.uid for s in flat)
    def run_simplify(keep_uids):
        """simplify with a forced kept-set; returns (kept, subs) or None if
        the forced set is inconsistent (signals circom eliminated cannot be
        eliminated under this set). The greedy pivot order can strand an
        eliminable signal (all its rows consumed as other pivots); stranded
        signals are retried as early-pivot preferences — pivot ORDER never
        changes the kept set, so the layout is unaffected."""
        prefer: set[int] = set()
        for _ in range(32):
            kept_c, subs = alg.simplify_constraints(
                el.constraints, forbidden, el.p, pos, level=opt,
                keep=keep_uids, prefer=frozenset(prefer),
                lin_seen=lin_seen,
            )
            kept = kept_c | forbidden | {
                u for u in el.pinned if u not in subs
            }
            if keep_uids is None:
                return kept, subs
            stuck = kept - keep_uids - forbidden
            if not stuck:
                return kept | keep_uids, subs
            if stuck <= prefer:  # no progress: genuinely inconsistent
                break
            prefer |= stuck
        stuck_acc.update(stuck)
        return None

    stuck_acc: set[int] = set()
    lin_seen: set[int] = set()  # all signals ever in a linear row

    if opt == 0:
        kept = set(el.sig_owner.keys())
    elif keep_labels is None:
        kept, subs = run_simplify(None)
    else:
        # r1cs kept-set (wire2label): circom's label space usually equals
        # `order` 1:1 (label l -> order[l-1]); a few circuits reserve a
        # small unused label block (observed: Poseidon(1), 2 labels after
        # the PoseidonEx header — docs/O2_LAYOUT_NOTES.md). n_labels tells
        # us the total slack G; when G > 0, search the gap-block position
        # over component-block boundaries, validating each candidate by
        # whether the simplifier can eliminate exactly the complement.
        labels = sorted(set(keep_labels))
        G = (n_labels - 1 - len(order)) if n_labels else 0
        if G < 0:
            raise ValueError(
                f"r1cs has {n_labels} labels but the circuit declares "
                f"{len(order)} signals — wrong circuit?"
            )

        def uids_for(gap_at: int) -> set[int] | None:
            s = set()
            for lbl in labels:
                i = lbl - 1 - (G if gap_at is not None and lbl > gap_at else 0)
                if not 0 <= i < len(order):
                    return None
                s.add(order[i].uid)
            return s

        if G == 0:
            cands = [None]
        else:
            # gap block starts at a component-block boundary: positions
            # where the owning component changes in `order`
            bounds, prev_owner = [], None
            for i, s in enumerate(order):
                own = el.sig_owner.get(s.uid)
                if own is not prev_owner:
                    bounds.append(i)  # gap sits just before order[i]
                    prev_owner = own
            bounds.append(len(order))
            cands = bounds
        result = None
        for gap_at in cands:
            ku = uids_for(gap_at)
            if ku is None or len(ku) != len(labels):
                continue
            r = run_simplify(ku)
            if r is not None:
                result = r
                break
        if result is None:
            raise LayoutReconcileError(
                "could not reconcile the r1cs wire2label map with this "
                "circuit's label order (r1cs from a different circuit or "
                "-O level?)",
                stuck_positions=sorted(
                    pos[u] for u in stuck_acc if u in pos
                ),
            )
        kept, subs = result

    slot_of: dict[int, int] = {}
    next_slot = 1
    for s in order:
        if s.uid in kept and s.uid not in slot_of:
            slot_of[s.uid] = next_slot
            next_slot += 1
    n_signals = next_slot - 1
    n_vars = n_signals + 1

    # eliminated signals still carry VM values (downstream ops read them):
    # they live in the temp space instead of the witness
    sig_temp: dict[int, int] = {}

    def conv_value(x):
        x = el.resolve(x)
        if isinstance(x, int):
            return ("c", x)
        if isinstance(x, Sig):
            sl = slot_of.get(x.uid)
            if sl is not None:
                return ("w", sl)
            t = sig_temp.get(x.uid)
            if t is None:
                t = el.n_temps + len(sig_temp)
                sig_temp[x.uid] = t
            return ("t", t)
        return ("t", x.tid)

    def slot(s: Sig) -> int:
        v = conv_value(s)
        if v[0] != "w":
            raise ValueError("main signal unexpectedly eliminated")
        return v[1]

    # ---- tape with slots, dead-op elimination, toposort into levels ----
    raw = []
    for op, dst, operands in el.ops:
        d = conv_value(dst)
        if d[0] == "c":
            continue  # write target folded away entirely
        raw.append((op, d, [conv_value(o) for o in operands]))

    # liveness from witness slots (=== evaluation and eliminated chains
    # leave dead temp ops behind; the MPC share path must not pay for them)
    producers: dict = {}
    for i, (_op, d, _ops_) in enumerate(raw):
        producers.setdefault(d, []).append(i)
    live: set[int] = set()
    seen_d = {d for d in producers if d[0] == "w"}
    work = list(seen_d)
    while work:
        d = work.pop()
        for i in producers.get(d, ()):
            if i in live:
                continue
            live.add(i)
            for o in raw[i][2]:
                if o[0] == "t" and o not in seen_d:
                    seen_d.add(o)
                    work.append(o)
    raw = [r for i, r in enumerate(raw) if i in live]

    # compact temp ids (inputs eliminated by O2 keep their temp homes)
    input_refs: dict[str, list] = {}
    for name, flat, _d in root.ins:
        input_refs[name] = [conv_value(s) for s in flat]
    used_t: set[int] = set()
    for _op, d, ops_ in raw:
        if d[0] == "t":
            used_t.add(d[1])
        for o in ops_:
            if o[0] == "t":
                used_t.add(o[1])
    for refs in input_refs.values():
        for r in refs:
            if r[0] == "t":
                used_t.add(r[1])
    remap = {old: i for i, old in enumerate(sorted(used_t))}

    def rconv(o):
        return ("t", remap[o[1]]) if o[0] == "t" else o

    raw = [(op, rconv(d), [rconv(o) for o in ops_]) for op, d, ops_ in raw]
    input_slots = {
        name: [r[1] if r[0] == "w" else n_vars + remap[r[1]] for r in refs]
        for name, refs in input_refs.items()
    }
    n_temps = len(remap)

    # producers
    produced_by = {}
    for i, (_op, d, _ops_) in enumerate(raw):
        produced_by.setdefault(d, i)
    level_of = [None] * len(raw)

    import sys

    sys.setrecursionlimit(1000000)

    def lvl(i):
        if level_of[i] is not None:
            return level_of[i]
        level_of[i] = 0  # break accidental cycles defensively
        m = 0
        for o in raw[i][2]:
            if o[0] in ("w", "t") and o in produced_by:
                m = max(m, lvl(produced_by[o]) + 1)
        level_of[i] = m
        return m

    for i in range(len(raw)):
        lvl(i)
    n_levels = (max(level_of) + 1) if raw else 0
    levels = [[] for _ in range(n_levels)]
    for i, (op, d, ops_) in enumerate(raw):
        levels[level_of[i]].append((op, d, ops_))

    def slots_for(bucket_list):
        out = {}
        for name, flat, _dims in bucket_list:
            out[name] = [slot(s) for s in flat]
        return out

    cc = CompiledCircuit(
        curve=curve,
        n_signals=n_signals,
        n_outputs=sum(len(f) for _n, f, _d in root.outs),
        input_slots=input_slots,
        output_slots=slots_for(root.outs),
        public_names=publics,
        levels=levels,
        n_temps=n_temps,
    )
    if os.environ.get("COCIRCOM_DEBUG_LAYOUT"):
        cc._debug = {
            "el": el,
            "order": order,
            "slot_of": slot_of,
            "act": act,
            "node_rank": node_rank,
            "root": root,
            "kept": kept,
            "lin_seen": lin_seen,
        }
    return cc


