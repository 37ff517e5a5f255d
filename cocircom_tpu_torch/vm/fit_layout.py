"""Pin a circuit's witness layout to a sample witness (no r1cs needed).

`compile_circom(keep_labels=...)` reproduces circom's witness layout when
an r1cs supplies the kept-label set (io/r1cs.py wire2label — the snarkjs
interop path). Users with only a circuit + one known-good snarkjs witness
(.wtns) can recover the same pin from the witness itself: the witness IS
the kept labels' values in label order, so matching its values into the
full (unsimplified) label-ordered value sequence identifies circom's kept
set even where the elimination-pivot heuristic diverges from ours
(docs/O2_LAYOUT_NOTES.md: poseidon t>=6 partial rounds et al.).

Method:
  1. compile at --O0 (all labels kept): host witness = value of EVERY
     label in label order, one sequence per provided input.
  2. match the committed witness entries (monotone in label order, value
     tuple across all inputs must agree) into that sequence:
       - global earliest/latest greedy passes bound every entry's
         feasible position range;
       - entries whose value is RARE (few occurrences in the full
         sequence) and already sits at the default-O2 kept position are
         anchored there — low-entropy values (bit signals are mostly
         0/1) never anchor, so a coincidental equality cannot pin a
         wrong position;
       - the stretches between anchors are solved by a small DP that
         maximizes agreement with the default-O2 kept set; if a stretch
         is unsatisfiable (an anchor WAS a coincidence), its boundary
         anchors are dropped and the windows merge (escalating to the
         full-sequence DP in the worst case).
  3. return 1-based keep_labels for `compile_circom(keep_labels=...,
     n_labels=...)`, which re-validates via the simplifier (a label set
     whose complement it cannot eliminate raises ValueError). Callers
     should assert byte-exactness on at least one held-out witness.

Reference parity: circom-types/src/r1cs.rs:75-104 consumes wire2label for
the same purpose when an r1cs exists; this recovers the map without one.
"""

from __future__ import annotations

import os
from collections import Counter

from .compiler import compile_circom
from .mpc_vm import WitnessExtension

# values occurring more often than this in the full label sequence are
# considered low-entropy and never used as anchors
RARE_MAX = 3


class AkInfeasible(ValueError):
    """A window was unsatisfiable under its always-kept constraints.

    The structural always-kept heuristic over-claims on circuits where a
    quad-collapse can eliminate a statically-quad-only signal
    (pedersen_test: 8 AK claims inside a 7-entry window).  Carrying the
    window's AK positions lets fit_keep_labels drop exactly the
    speculative claims and re-solve."""

    def __init__(self, msg, ak_positions):
        super().__init__(msg)
        self.ak_positions = tuple(ak_positions)


def _host_runs(src, curve, link, inputs_list, opt):
    """Compile at `opt` and run every input on the host path.  run_host
    computes on Python ints and gives the driver no work, so the plain
    driver it is built over lives on the CPU."""
    from ..mpc.driver import PlainDriver

    keep = os.environ.get("COCIRCOM_DEBUG_LAYOUT")
    os.environ["COCIRCOM_DEBUG_LAYOUT"] = "1"
    try:
        cc = compile_circom(src, curve, link=link, opt=opt)
    finally:
        if keep is None:
            os.environ.pop("COCIRCOM_DEBUG_LAYOUT", None)
        else:
            os.environ["COCIRCOM_DEBUG_LAYOUT"] = keep
    vm = WitnessExtension(PlainDriver(curve, device="cpu"), cc)
    return cc, [vm.run_host(inp) for inp in inputs_list]


def fit_keep_labels(src, curve, link, inputs_list, wants, extra_ak=()):
    """Fit circom's kept-label set from committed witnesses.

    inputs_list: list of input dicts; wants: matching list of full circom
    witness value lists (ints, index 0 == 1). extra_ak: 0-based full-order
    positions that MUST be chosen (simplifier-feasibility feedback from
    fit_keep_labels_validated). Returns (keep_labels, n_labels) for
    compile_circom."""
    assert len(inputs_list) == len(wants) and wants
    W = len(wants[0])
    assert all(len(w) == W for w in wants), "witness lengths differ"

    cc0, fulls = _host_runs(src, curve, link, inputs_list, opt=0)
    order = cc0._debug["order"]
    F = len(fulls[0])
    assert F == len(order) + 1, (F, len(order))

    # default-O2 kept set as positions in the full label order (prior)
    cc2, _ = _host_runs(src, curve, link, inputs_list[:1], opt=2)
    kept2 = cc2._debug["kept"]
    order2 = cc2._debug["order"]
    prior = [i for i, s in enumerate(order2) if s.uid in kept2]

    # structurally-always-kept positions: only signals of LINEAR
    # constraints can ever be Gauss-eliminated (vm/algebra.py), so a
    # signal outside every linear constraint keeps its slot in EVERY
    # valid layout — circom's included. These pin most of a bit-heavy
    # circuit (sha256: nonlinear b*c constraints everywhere), leaving the
    # value-matching DP only the true linear-cluster ambiguity.
    # Signals that EVER appeared in a linear row during the default-O2
    # simplify (including rows born from quad collapse — compiler
    # _debug["lin_seen"]). A quad-only signal by the static is_linear()
    # test can still be eliminated through a collapsing quad, so the
    # static set over-claims always-kept positions (pedersen_test: 8
    # claims for a 7-entry window).
    elim_cand: set = set(cc2._debug["lin_seen"])
    ak = sorted(
        set(
            i for i, s in enumerate(order2)
            if s.uid in kept2 and s.uid not in elim_cand
        )
        | set(extra_ak)
    )

    # value tuples (one per input) for want entry j / full position p
    wv = [tuple(w[j] for w in wants) for j in range(1, W)]
    fv = [tuple(f[1 + p] for f in fulls) for p in range(F - 1)]
    n = len(wv)
    if len(prior) != n:
        raise ValueError(
            f"witness length {W} != default-O2 kept count {len(prior) + 1}"
        )

    # global feasible-position bounds
    e = [0] * n
    p = 0
    for j in range(n):
        while p < len(fv) and fv[p] != wv[j]:
            p += 1
        if p >= len(fv):
            raise ValueError(
                f"witness entry {j + 1} has no matching label value — "
                "wrong circuit/witness pair?"
            )
        e[j] = p
        p += 1
    lt = [0] * n
    p = len(fv) - 1
    for j in range(n - 1, -1, -1):
        while p >= 0 and fv[p] != wv[j]:
            p -= 1
        assert p >= 0  # earliest pass proved feasibility
        lt[j] = p
        p -= 1

    freq = Counter(fv)
    prior_set = set(prior)
    mandatory = set(extra_ak)
    cur_ak = list(ak)
    for _ in range(64):
        try:
            return _assign(
                wv, fv, e, lt, prior, prior_set, freq, cur_ak), F
        except AkInfeasible as ex:
            # shed the window's SPECULATIVE structural claims (never the
            # simplifier-mandated extra_ak anchors) and re-solve
            shed = set(ex.ak_positions) - mandatory
            if not shed:
                raise
            cur_ak = [a for a in cur_ak if a not in shed]
        except ValueError:
            if set(cur_ak) == mandatory:
                raise
            # structural anchors failed some other way: mandatory only
            cur_ak = sorted(mandatory)
    raise ValueError("AK shedding did not converge after 64 rounds")


def fit_keep_labels_validated(src, curve, link, inputs_list, wants,
                              max_rounds=24):
    """fit_keep_labels + simplifier-feasibility feedback via anchors.

    The value-matching DP can land on an assignment the simplifier cannot
    realize: inside a zero-run (all-inputs-equal values) the witness
    cannot distinguish which twin circom kept (pedersen_test diverges at
    2 of 1996 positions this way), and the DP\'s pick may be structurally
    un-eliminable the other way around. compile_circom re-validates the
    pin; its LayoutReconcileError names the positions it refused to
    eliminate; those become mandatory anchors (extra_ak) for a refit, so
    the DP re-solves globally with them pinned — the refit stays
    byte-exact by construction (positions only ever move between value
    twins)."""
    from .compiler import LayoutReconcileError

    # `extra` is ORDERED oldest-first: each simplifier round's stuck
    # positions are conditional on that round's twin assignment, so when
    # anchors over-constrain a window (AkInfeasible on mandatory anchors
    # — pedersen_test accumulates 8 anchors for a 7-entry window) the
    # OLDEST anchor inside the failing window is the displaced twin and
    # is dropped before retrying.
    extra: list[int] = []
    seen: set[tuple] = set()
    for _ in range(max_rounds):
        state = tuple(sorted(extra))
        if state in seen and extra:
            extra.pop(0)  # break feedback cycles by forgetting history
            continue
        seen.add(state)
        try:
            keep, nl = fit_keep_labels(
                src, curve, link, inputs_list, wants, extra_ak=extra
            )
        except AkInfeasible as ex:
            window = set(ex.ak_positions)
            for a in extra:
                if a in window:
                    extra.remove(a)
                    break
            else:
                raise
            continue
        try:
            compile_circom(
                src, curve, link=link, keep_labels=keep, n_labels=nl
            )
            return keep, nl
        except LayoutReconcileError as ex:
            new = [a for a in ex.stuck_positions if a not in extra]
            if not new:
                raise
            extra.extend(new)
    raise ValueError(
        f"layout fit did not converge after {max_rounds} anchored rounds"
    )


def _assign(wv, fv, e, lt, prior, prior_set, freq, ak):
    import bisect

    n = len(wv)
    ak_set = set(ak)

    def anchored(j):
        return (
            fv[prior[j]] == wv[j]
            and freq[wv[j]] <= RARE_MAX
            and e[j] <= prior[j] <= lt[j]
        )

    pos: list[int | None] = [None] * n
    forced = [False] * n
    for j in range(n):
        if e[j] == lt[j]:
            pos[j] = e[j]
            forced[j] = True
        elif anchored(j):
            pos[j] = prior[j]

    # drop anchors whose adjacency skips an always-kept position (nothing
    # could ever use it) — repeat until stable; forced entries stay
    def ak_between(a, b):  # any AK strictly inside (a, b)?
        i = bisect.bisect_right(ak, a)
        return i < len(ak) and ak[i] < b

    changed = True
    while changed and ak:
        changed = False
        last = -1  # position of previous filled entry (virtual start)
        last_j = None
        for j in range(n):
            if pos[j] is None:
                last = -2  # a window will cover the gap
                continue
            if last != -2 and ak_between(last, pos[j]):
                if not forced[j]:
                    pos[j] = None
                    changed = True
                elif last_j is not None and not forced[last_j]:
                    pos[last_j] = None
                    changed = True
                else:
                    raise ValueError(
                        "forced entries skip an always-kept label"
                    )
            last = pos[j] if pos[j] is not None else -2
            last_j = j
        # trailing AK above the last filled entry
        if pos[n - 1] is not None and ak and ak[-1] > pos[n - 1]:
            if forced[n - 1]:
                raise ValueError("forced tail skips an always-kept label")
            pos[n - 1] = None
            changed = True

    # solve stretches between anchors; on unsatisfiability, drop the
    # boundary anchors and widen (forced e==lt entries are never dropped)
    j = 0
    while j < n:
        if pos[j] is not None:
            j += 1
            continue
        j0 = j
        while j < n and pos[j] is None:
            j += 1
        j1 = j
        while True:
            lo = pos[j0 - 1] + 1 if j0 > 0 else 0
            hi = (pos[j1] - 1) if j1 < n else (len(fv) - 1)
            try:
                _solve_window(
                    wv, fv, prior_set, pos, e, lt, j0, j1, lo, hi, ak
                )
                break
            except ValueError:
                widened = False
                if j0 > 0 and not forced[j0 - 1]:
                    j0 -= 1
                    pos[j0] = None
                    widened = True
                if j1 < n and not forced[j1]:
                    pos[j1] = None
                    j1 += 1
                    widened = True
                if not widened:
                    raise
        j = j1
    return [q + 1 for q in pos]


def _solve_window(wv, fv, prior, pos, e, lt, j0, j1, lo, hi, ak=()):
    """Fill pos[j0:j1) with strictly-increasing positions in [lo, hi]
    (further bounded by the global e/lt ranges) whose values match,
    maximizing membership in `prior`. Positions in `ak` (sorted,
    always-kept) inside the window MUST all be used."""
    import bisect

    akw = ak[bisect.bisect_left(ak, lo):bisect.bisect_right(ak, hi)] \
        if ak else []
    if akw or (j1 - j0) * (hi - lo + 1) > 200_000:
        return _solve_window_np(
            wv, fv, prior, pos, e, lt, j0, j1, lo, hi, akw
        )
    best_prev: dict[int, int] = {}
    back: list[dict] = []
    for j in range(j0, j1):
        cur: dict[int, int] = {}
        bk: dict = {}
        run_best, run_arg = -1, None
        prev_items = sorted(best_prev.items())
        pi = 0
        for pp in range(max(lo, e[j]), min(hi, lt[j]) + 1):
            while pi < len(prev_items) and prev_items[pi][0] < pp:
                if prev_items[pi][1] > run_best:
                    run_best = prev_items[pi][1]
                    run_arg = prev_items[pi][0]
                pi += 1
            if fv[pp] != wv[j]:
                continue
            if j > j0:
                if run_best < 0:
                    continue
                base = run_best
            else:
                base = 0
            cur[pp] = base + (1 if pp in prior else 0)
            bk[pp] = run_arg
        if not cur:
            raise ValueError(
                f"witness entries {j0 + 1}..{j1} cannot be matched inside "
                f"label window [{lo}, {hi}]"
            )
        best_prev = cur
        back.append(bk)
    pbest = max(best_prev, key=lambda q: best_prev[q])
    for j in range(j1 - 1, j0 - 1, -1):
        pos[j] = pbest
        pbest = back[j - j0][pbest]


def _solve_window_np(wv, fv, prior, pos, e, lt, j0, j1, lo, hi, akw=()):
    """Vectorized variant of _solve_window for big stretches (sha256-class
    bit runs) and for windows containing always-kept positions: per-row
    score arrays over the window with prefix-max/argmax transitions.

    The always-kept constraint rides the transition: a step q -> pp may
    not skip an AK position in (q, pp), so the usable predecessors of pp
    are exactly the positions of the LAST AK-delimited segment before pp.
    With per-segment ids, a single prefix-max over (score + seg*K) floats
    picks the best predecessor of the latest segment; a transition whose
    winning predecessor is from an older segment is invalid."""
    import numpy as np

    win = hi - lo + 1
    ids: dict = {}
    fvid = np.fromiter(
        (ids.setdefault(fv[p], len(ids)) for p in range(lo, hi + 1)),
        dtype=np.int64, count=win,
    )
    prior_mask = np.fromiter(
        ((1 if (lo + i) in prior else 0) for i in range(win)),
        dtype=np.float64, count=win,
    )
    idx = np.arange(win)
    # segment id per window offset: number of AK positions <= offset
    akrel = np.asarray([a - lo for a in akw], dtype=np.int64)
    seg = np.searchsorted(akrel, idx, side="right").astype(np.float64)
    seg_prev = np.concatenate(([0.0], seg[:-1]))  # seg of pp-1
    K = float(4 * (j1 - j0) + 8)
    NEG = -np.inf
    prev = None
    backs: list = []
    for j in range(j0, j1):
        match = fvid == ids.get(wv[j], -2)
        if j == j0:
            # no AK may sit strictly below the first used position
            ok0 = seg_prev == 0
            cur = np.where(match & ok0, prior_mask, NEG)
            backs.append(None)
        else:
            T = prev + seg * K
            M = np.maximum.accumulate(T)
            parg = np.maximum.accumulate(np.where(T >= M, idx, -1))
            Ms = np.concatenate(([NEG], M[:-1]))
            sarg = np.concatenate(([0], parg[:-1])).astype(np.int64)
            # valid only if the winning predecessor is in the newest
            # segment before pp (no AK skipped) and finite
            base = Ms - seg_prev * K
            okseg = np.isfinite(Ms) & (seg[sarg] == seg_prev)
            cur = np.where(match & okseg, base + prior_mask, NEG)
            backs.append(sarg)
        a, b = max(0, e[j] - lo), lt[j] - lo
        cur[:a] = NEG
        cur[b + 1:] = NEG
        if not np.isfinite(cur.max()):
            msg = (f"witness entries {j0 + 1}..{j1} cannot be matched "
                   f"inside label window [{lo}, {hi}]")
            if len(akrel):
                raise AkInfeasible(msg, akw)
            raise ValueError(msg)
        prev = cur
    # the last used position must leave no AK above it
    tail_ok = seg >= (len(akrel))
    final = np.where(tail_ok, prev, NEG)
    if not np.isfinite(final.max()):
        raise AkInfeasible(
            f"witness entries {j0 + 1}..{j1} leave an always-kept label "
            f"unused in window [{lo}, {hi}]", akw,
        )
    p = int(np.argmax(final))
    for j in range(j1 - 1, j0 - 1, -1):
        pos[j] = lo + p
        if backs[j - j0] is not None:
            p = int(backs[j - j0][p])
