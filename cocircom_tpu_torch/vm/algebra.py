"""Constraint algebra + circom O2 constraint simplification.

circom's constraint generation represents every constrainable expression as
an arithmetic expression of degree <= 2 over signals: Number, Linear, or
Quadratic(a, b, c) meaning a*b + c with a, b, c linear. `<==`/`===` emit one
R1CS constraint each; `--O2` then runs *full constraint simplification*:
signal-to-signal / signal-to-constant substitution plus a Gaussian
linear-substitution fixpoint, and prunes every signal that no longer occurs
in the remaining constraint system (upstream entry point:
co-circom/circom-mpc-compiler/src/lib.rs:171-190, BuildConfig
{no_rounds: MAX} i.e. SimplificationLevel::O2(usize::MAX)).

The upstream circom sources are not vendored here, so the exact pivot /
representative choices below were reverse-engineered against the 60
KAT witnesses of the upstream test vectors
(test_vectors/WitnessExtension/kats; the JAX package's tests/test_kat_sweep
is the byte-exactness fence):

  * equality constraints (c*s1 - c*s2 = 0) cluster under union-find; the
    representative is a forbidden (public) member if present, else the
    minimum-uid member;
  * a linear constraint eliminates its maximum-uid non-forbidden signal;
  * substitutions are applied into the quadratic constraints; a quadratic
    whose a- or b-side collapses to a constant re-enters the linear phase
    (the O2 "rounds" fixpoint);
  * surviving witness signals = signals occurring in the fully-substituted
    remaining constraints, plus the forbidden (public) set.

Only the `forbidden` set (the constant wire, main outputs, PUBLIC main
inputs) is protected: circom --O2 happily eliminates private main inputs
(e.g. the `functions` KAT witness is just [1, out]).
"""

from __future__ import annotations

import os

CONST = -1  # LC key for the constant term


# ---------------------------------------------------------------- LC helpers
# An LC is a dict {signal_uid: coeff} (plus CONST key), coeffs in [1, p-1];
# zero coefficients are always dropped.


def lc_const(v: int, p: int) -> dict:
    v %= p
    return {CONST: v} if v else {}


def lc_sig(uid: int) -> dict:
    return {uid: 1}


def lc_add(a: dict, b: dict, p: int) -> dict:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) + v) % p
        if nv:
            out[k] = nv
        else:
            out.pop(k, None)
    return out


def lc_scale(a: dict, c: int, p: int) -> dict:
    c %= p
    if not c:
        return {}
    return {k: (v * c) % p for k, v in a.items()}


def lc_sub(a: dict, b: dict, p: int) -> dict:
    return lc_add(a, lc_scale(b, p - 1, p), p)


def lc_is_const(a: dict) -> bool:
    return all(k == CONST for k in a)


def lc_signals(a: dict):
    return [k for k in a if k != CONST]


# ------------------------------------------------------------ AExpr algebra
# Values carried alongside elaboration: ("lc", LC) | ("quad", A, B, C) | None
# (not representable as a degree<=2 polynomial — e.g. comparisons, which in
# vanilla circom may only feed `<--` assignments).


def ae_const(v: int, p: int):
    return ("lc", lc_const(v, p))


def ae_sig(uid: int):
    return ("lc", lc_sig(uid))


def ae_add(x, y, p):
    if x is None or y is None:
        return None
    if x[0] == "lc" and y[0] == "lc":
        return ("lc", lc_add(x[1], y[1], p))
    if x[0] == "quad" and y[0] == "lc":
        return ("quad", x[1], x[2], lc_add(x[3], y[1], p))
    if x[0] == "lc" and y[0] == "quad":
        return ("quad", y[1], y[2], lc_add(y[3], x[1], p))
    return None  # quad + quad exceeds degree 2 bookkeeping


def ae_neg(x, p):
    if x is None:
        return None
    if x[0] == "lc":
        return ("lc", lc_scale(x[1], p - 1, p))
    return ("quad", x[1], lc_scale(x[2], p - 1, p), lc_scale(x[3], p - 1, p))


def ae_sub(x, y, p):
    return ae_add(x, ae_neg(y, p), p)


def ae_mul(x, y, p):
    if x is None or y is None:
        return None
    if x[0] == "lc" and lc_is_const(x[1]):
        c = x[1].get(CONST, 0)
        if y[0] == "lc":
            return ("lc", lc_scale(y[1], c, p))
        return ("quad", y[1], lc_scale(y[2], c, p), lc_scale(y[3], c, p))
    if y[0] == "lc" and lc_is_const(y[1]):
        return ae_mul(y, x, p)
    if x[0] == "lc" and y[0] == "lc":
        return ("quad", x[1], y[1], {})
    return None


def ae_div(x, y, p):
    if x is None or y is None:
        return None
    if y[0] == "lc" and lc_is_const(y[1]):
        c = y[1].get(CONST, 0)
        if not c:
            return None
        return ae_mul(("lc", lc_const(pow(c, -1, p), p)), x, p)
    return None


# -------------------------------------------------------------- constraints


class Constraint:
    """A*B + C = 0 with A, B, C linear (A=B=None when the constraint is
    linear). Mirrors circom_algebra's Constraint { a, b, c }."""

    __slots__ = ("a", "b", "c")

    def __init__(self, a, b, c):
        self.a = a
        self.b = b
        self.c = c

    @staticmethod
    def from_ae(ae, p):
        """Constraint asserting ae == 0 (ae must not be None)."""
        if ae[0] == "lc":
            return Constraint(None, None, ae[1])
        return Constraint(ae[1], ae[2], ae[3])

    def is_linear(self) -> bool:
        return (
            self.a is None
            or self.b is None
            or lc_is_const(self.a)
            or lc_is_const(self.b)
        )

    def linearized(self, p) -> dict:
        """The LC form of a linear constraint (folds a constant a/b side)."""
        if self.a is None or self.b is None:
            return self.c
        if lc_is_const(self.a):
            return lc_add(lc_scale(self.b, self.a.get(CONST, 0), p), self.c, p)
        return lc_add(lc_scale(self.a, self.b.get(CONST, 0), p), self.c, p)


class SubstitutionMap:
    """uid -> LC substitutions with on-demand full resolution (substitution
    RHSes may reference signals eliminated later)."""

    def __init__(self, p: int):
        self.p = p
        self.raw: dict[int, dict] = {}
        self._resolved: dict[int, dict] = {}

    def __contains__(self, uid):
        return uid in self.raw

    def add(self, uid: int, lc: dict):
        self.raw[uid] = lc
        self._resolved.clear()

    def resolve_sig(self, uid: int) -> dict:
        done = self._resolved.get(uid)
        if done is not None:
            return done
        # iterative expansion (chains can be deep: long <== cascades)
        lc = self.raw[uid]
        seen = {uid}
        while True:
            hit = None
            for k in lc:
                if k != CONST and k in self.raw:
                    hit = k
                    break
            if hit is None:
                break
            if hit in seen:
                raise ValueError("cyclic substitution")
            sub = self._resolved.get(hit)
            if sub is None:
                sub = self.resolve_sig(hit)
            coeff = lc[hit]
            lc = dict(lc)
            del lc[hit]
            lc = lc_add(lc, lc_scale(sub, coeff, self.p), self.p)
        self._resolved[uid] = lc
        return lc

    def apply(self, lc: dict) -> dict:
        if not any(k != CONST and k in self.raw for k in lc):
            return lc
        out = {}
        for k, v in lc.items():
            if k != CONST and k in self.raw:
                out = lc_add(out, lc_scale(self.resolve_sig(k), v, self.p), self.p)
            else:
                out = lc_add(out, {k: v}, self.p)
        return out


def simplify_constraints(constraints, forbidden, p, pos, level: int = 2,
                         keep=None, prefer=frozenset(), lin_seen=None):
    """Run circom's constraint simplification.

    constraints: list[Constraint] in generation order.
    forbidden: set of signal uids that must keep witness slots (public wires).
    pos: uid -> witness-layout position (main block first, then component
        nodes by descending completion rank — compiler.compile_circom). Every
        elimination choice is positional: a linear constraint eliminates its
        MAXIMUM-position non-forbidden signal, so equality constraints keep
        the earliest-laid-out member (fitted against the 60 KAT witnesses;
        e.g. `mulFix.e[i] <== pvkBits.out[i]` in BabyPbk keeps mulFix.e —
        EscalarMulFix completes later, so its block precedes Num2Bits').
    level: 0 = none, 1 = only signal-to-signal / signal-to-constant
        substitution (circom --O1), 2 = full linear Gauss fixpoint
        (circom --O2, unlimited rounds).
    keep: optional set of signal uids that must ALSO keep witness slots —
        the r1cs kept-set (wire2label, circom-types/src/r1cs.rs:75-104).
        When the target layout is known from a committed r1cs, pivoting is
        constrained to eliminate only signals OUTSIDE this set, which
        reproduces circom's layout exactly regardless of its internal
        pivot heuristic (the eliminated set determines the layout; any
        Gauss order over the same eliminated set yields equivalent
        substitutions).
    prefer: signal uids to pivot on EARLY. The single-pass greedy
        max-position pivot can strand a to-be-eliminated signal inside
        substitution chains (every row containing it gets consumed as
        another signal's pivot) even though a valid elimination order
        exists; callers retry with the stranded signals in `prefer`
        (compiler.run_simplify). Order changes only the substitution
        route, never the kept set, so the witness layout is unaffected.
    lin_seen: optional set; filled with every signal that appears in a
        linear row at ANY point of the run — including rows born from
        quad collapse. This is the true "could be Gauss-eliminated"
        candidate set (fit_layout's structural always-kept prior must use
        it: a signal linear only via a collapsing quad IS eliminable).

    Returns (kept_uids: set, subs: SubstitutionMap). kept_uids contains every
    signal that occurs in the simplified system; callers must union it with
    the forbidden set (and any unconstrainable-but-pinned signals).
    """
    if keep:
        forbidden = forbidden | keep
    subs = SubstitutionMap(p)
    if level == 0:
        kept = set()
        for c in constraints:
            for lc in (c.a, c.b, c.c):
                if lc:
                    kept.update(lc_signals(lc))
        return kept, subs

    linear: list[dict] = []
    quads: list[Constraint] = []
    for c in constraints:
        if c.is_linear():
            lin = c.linearized(p)
            if lin:
                linear.append(lin)
        else:
            quads.append(c)

    retained: list[dict] = []  # linear constraints kept in the system

    def is_o1(lc) -> bool:
        """signal = signal (opposite coeffs, no constant) or signal = const"""
        sig = lc_signals(lc)
        if len(sig) == 1:
            return True
        return (
            len(sig) == 2
            and CONST not in lc
            and (lc[sig[0]] + lc[sig[1]]) % p == 0
        )

    variant = os.environ.get("COCIRCOM_SIMP_VARIANT", "gen")

    def reorder(lcs):
        if variant == "gen" or not lcs:
            return lcs

        def key(lc):
            sig = [s for s in lc_signals(lc) if s not in forbidden]
            return max((pos[s] for s in sig), default=-1)

        if variant == "desc":
            return sorted(lcs, key=key, reverse=True)
        if variant == "asc":
            return sorted(lcs, key=key)
        if variant == "o1first":
            return [lc for lc in lcs if is_o1(lc)] + [
                lc for lc in lcs if not is_o1(lc)
            ]
        return lcs

    while True:
        for lc0 in reorder(linear):
            lc = subs.apply(lc0)
            if lin_seen is not None:
                lin_seen.update(lc_signals(lc))
            sig = [s for s in lc_signals(lc) if s not in forbidden]
            if not sig:
                if lc_signals(lc):
                    retained.append(lc)
                elif lc.get(CONST, 0):
                    raise ValueError("unsatisfiable linear constraint")
                continue
            if level == 1 and not is_o1(lc):
                retained.append(lc)
                continue
            pivot = max(sig, key=lambda s: (s in prefer, pos[s]))
            rhs = lc_scale(
                {k: v for k, v in lc.items() if k != pivot},
                (p - pow(lc[pivot], -1, p)) % p,
                p,
            )
            subs.add(pivot, rhs)

        # O2 rounds fixpoint: quadratics whose a/b side collapses to a
        # constant become linear and re-enter the loop
        new_linear = []
        still_quads = []
        for q in quads:
            a = subs.apply(q.a)
            b = subs.apply(q.b)
            if lc_is_const(a) or lc_is_const(b):
                lin = Constraint(a, b, subs.apply(q.c)).linearized(p)
                if lin:
                    new_linear.append(lin)
            else:
                still_quads.append(q)
        quads = still_quads

        # Retained rows re-checked under the UPDATED subs: a row retained
        # when its visible support was all-kept can re-gain an eliminable
        # signal through a substitution chain added later (forced-keep
        # mode strands signals this way — pedersen_test uid@6978).
        re_lin = []
        still_ret = []
        for lc in retained:
            a = subs.apply(lc)
            elim = [s for s in lc_signals(a) if s not in forbidden]
            if elim and (level != 1 or is_o1(a)):
                re_lin.append(a)
            else:
                still_ret.append(lc)
        retained = still_ret

        if not new_linear and not re_lin:
            break
        linear = new_linear + re_lin

    kept: set[int] = set()
    for lc in retained:
        kept.update(s for s in lc_signals(subs.apply(lc)))
    for q in quads:
        for lc in (q.a, q.b, q.c):
            kept.update(lc_signals(subs.apply(lc)))
    return kept, subs
