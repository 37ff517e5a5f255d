"""Sumcheck prover + verifier for UltraHonk.

Parity: upstream co-noir/ultrahonk/src/decider/sumcheck/
(prover.rs sumcheck_prove :70-175, round_prover.rs compute_univariate
:200-243 / batch_over_relations :100-110, verifier.rs sumcheck_verify
:15-95, round_verifier.rs check_sum/compute_next_target_sum
:40-56, univariate.rs extend_from/evaluate, decider/types.rs
GateSeparatorPolynomial :40-97).

Batched redesign of the hot loop: instead of the reference's per-edge
scalar loop, every entity is laid out as an (E,) vector over edges and
extended to all BATCHED_LENGTH=8 evaluation points at once; the 26
subrelation formulas (relations.py) evaluate over (8, E) arrays and the
edge axis is reduced with a beta-product weighted sum. The per-
subrelation results are truncated to the reference's accumulator lengths
and barycentric-extended back to 8 points so the transcript bytes match
the reference exactly.
"""

from __future__ import annotations

import numpy as np

from .builder import P
from .relations import (
    SUBRELATION_IS_LINEARLY_INDEPENDENT,
    SUBRELATION_LENGTHS,
    evaluate_relations,
)

BATCHED_LENGTH = 8  # MAX_PARTIAL_RELATION_LENGTH + 1
CONST_PROOF_SIZE_LOG_N = 28


# ------------------------------------------------------------ barycentric

def _extension_matrix(length: int, target: int):
    """Row k (length..target-1): Lagrange weights mapping evals at
    0..length-1 to the eval at k. Exact (Fr arithmetic)."""
    rows = []
    for k in range(length, target):
        weights = []
        for j in range(length):
            num = 1
            den = 1
            for m in range(length):
                if m != j:
                    num = num * (k - m) % P
                    den = den * (j - m) % P
            weights.append(num * pow(den, -1, P) % P)
        rows.append(weights)
    return rows


_EXT_CACHE: dict = {}


def extend_evals(evals: list[int], target: int) -> list[int]:
    """Barycentric extension of evaluations at 0..len-1 to 0..target-1."""
    length = len(evals)
    if length >= target:
        return list(evals[:target])
    key = (length, target)
    if key not in _EXT_CACHE:
        _EXT_CACHE[key] = _extension_matrix(length, target)
    out = list(evals)
    for row in _EXT_CACHE[key]:
        out.append(sum(w * e for w, e in zip(row, evals)) % P)
    return out


def evaluate_univariate(evals: list[int], u: int) -> int:
    """Value at u of the degree-(len-1) poly with evaluations at 0..len-1."""
    u %= P
    n = len(evals)
    if u < n:
        return evals[u]
    num = 1
    for i in range(n):
        num = num * (u - i) % P
    res = 0
    for j in range(n):
        den = 1
        for m in range(n):
            if m != j:
                den = den * (j - m) % P
        den = den * (u - j) % P
        res = (res + evals[j] * pow(den, -1, P)) % P
    return res * num % P


# ------------------------------------------------------- gate separators

class GateSeparator:
    """decider/types.rs:40-97."""

    def __init__(self, betas: list[int], log_n: int, with_products=True):
        self.betas = betas
        self.partial_evaluation_result = 1
        self.idx = 0
        self.periodicity = 2
        if with_products:
            size = 1 << log_n
            prod = [1] * size
            for i, beta in enumerate(betas[:log_n]):
                index = 1 << i
                prod[index] = beta
                for j in range(1, index):
                    prod[index + j] = prod[j] * beta % P
            self.beta_products = prod
        else:
            self.beta_products = []

    def current(self) -> int:
        return self.betas[self.idx]

    def partially_evaluate(self, u: int):
        self.partial_evaluation_result = (
            self.partial_evaluation_result * (1 + u * (self.current() - 1))) % P
        self.idx += 1
        self.periodicity *= 2


# ------------------------------------------------------------- the prover

def _entity_dict_at_points(polys: dict, round_size: int):
    """For each entity (list/array of len >= round_size), build an (8, E)
    object array: row k = v_even + k*(v_odd - v_even) mod p."""
    E = round_size // 2
    out = {}
    for name, poly in polys.items():
        a = np.array(poly[:round_size:2], dtype=object)
        b = np.array(poly[1:round_size:2], dtype=object)
        d = (b - a) % P
        rows = [a]
        cur = a
        for _ in range(1, BATCHED_LENGTH):
            cur = (cur + d) % P
            rows.append(cur)
        out[name] = np.stack(rows)  # (8, E)
    return out


def _compute_round_univariate(entities: dict, rp: dict, beta_products,
                              periodicity: int, partial_eval: int,
                              alphas: list[int], pow_current: int):
    """One sumcheck round univariate (8 evaluations), reference-exact."""
    E = next(iter(entities.values())).shape[1]
    scaling = np.array(
        [beta_products[(e >> 0) * periodicity] for e in range(E)], dtype=object
    )
    subvals = evaluate_relations(entities, rp)  # 26 arrays (8, E)

    # extended random polynomial (1-X) + X*beta at points 0..7
    ext_rand = [(1 + k * (pow_current - 1)) % P for k in range(BATCHED_LENGTH)]

    result = [0] * BATCHED_LENGTH
    alpha_iter = [1] + list(alphas)
    for sub_idx, vals in enumerate(subvals):
        # edge reduction with beta-product scaling (per-edge scaling_factor);
        # the linearly-DEPENDENT subrelation is accumulated unweighted — its
        # formula ignores scaling_factor (logderiv_lookup_relation.rs:226)
        if SUBRELATION_IS_LINEARLY_INDEPENDENT[sub_idx]:
            summed = (vals * scaling) % P  # (8, E)
        else:
            summed = vals % P
        summed = np.sum(summed, axis=1) % P  # (8,)
        alpha = alpha_iter[sub_idx]
        # truncate to the reference accumulator length, then extend — for
        # degree-correct subrelations this is the identity, and it
        # reproduces the reference bytes exactly
        acc = [(int(v) * alpha) % P for v in summed[: SUBRELATION_LENGTHS[sub_idx]]]
        ext = extend_evals(acc, BATCHED_LENGTH)
        if SUBRELATION_IS_LINEARLY_INDEPENDENT[sub_idx]:
            for k in range(BATCHED_LENGTH):
                result[k] = (result[k]
                             + ext[k] * ext_rand[k] % P * partial_eval) % P
        else:
            for k in range(BATCHED_LENGTH):
                result[k] = (result[k] + ext[k]) % P
    return result


def sumcheck_prove(polys: dict, rp: dict, circuit_size: int, transcript):
    """polys: entity name -> list[int] of len circuit_size (incl. shifted).
    Returns (claimed_evaluations dict, challenges list)."""
    n = circuit_size
    d = n.bit_length() - 1
    gate_challenges = rp["gate_challenges"]
    gs = GateSeparator(gate_challenges, d)

    challenges = []
    round_size = n
    current = polys
    for round_idx in range(d):
        entities = _entity_dict_at_points(current, round_size)
        univariate = _compute_round_univariate(
            entities, rp, gs.beta_products, gs.periodicity,
            gs.partial_evaluation_result, rp["alphas"], gs.current(),
        )
        transcript.send_fr_vec(f"Sumcheck:univariate_{round_idx}", univariate)
        u = transcript.get_challenge(f"Sumcheck:u_{round_idx}")
        challenges.append(u)

        # partially evaluate all polys: p'[i] = p[2i] + u (p[2i+1] - p[2i])
        nxt = {}
        for name, poly in current.items():
            a = np.array(poly[:round_size:2], dtype=object)
            b = np.array(poly[1:round_size:2], dtype=object)
            nxt[name] = list(((b - a) % P * u + a) % P)
        current = nxt
        gs.partially_evaluate(u)
        round_size >>= 1

    zero_univariate = [0] * BATCHED_LENGTH
    for idx in range(d, CONST_PROOF_SIZE_LOG_N):
        transcript.send_fr_vec(f"Sumcheck:univariate_{idx}", zero_univariate)
        challenges.append(transcript.get_challenge(f"Sumcheck:u_{idx}"))

    claimed = {name: int(poly[0]) % P for name, poly in current.items()}
    from .relations import ALL_ENTITY_NAMES

    transcript.send_fr_vec(
        "Sumcheck:evaluations", [claimed[nm] for nm in ALL_ENTITY_NAMES]
    )
    return claimed, challenges


# ----------------------------------------------------------- the verifier

def sumcheck_verify(rp: dict, circuit_size: int, transcript):
    """Returns (claimed_evaluations dict, challenges, verified)."""
    from .relations import ALL_ENTITY_NAMES, NUM_ALL_ENTITIES

    d = circuit_size.bit_length() - 1
    if d == 0:
        raise ValueError("Number of variables in multivariate is 0")
    gs = GateSeparator(rp["gate_challenges"], d, with_products=False)

    verified = True
    target = 0
    challenges = []
    for round_idx in range(CONST_PROOF_SIZE_LOG_N):
        evals = transcript.receive_fr_vec(
            f"Sumcheck:univariate_{round_idx}", BATCHED_LENGTH
        )
        u = transcript.get_challenge(f"Sumcheck:u_{round_idx}")
        if round_idx < d:
            verified = verified and ((evals[0] + evals[1]) % P == target % P)
            challenges.append(u)
            target = evaluate_univariate(evals, u)
            gs.partially_evaluate(u)
        else:
            challenges.append(u)

    evals = transcript.receive_fr_vec("Sumcheck:evaluations", NUM_ALL_ENTITIES)
    claimed = dict(zip(ALL_ENTITY_NAMES, evals))

    # full purported value: relations at the claimed evaluations, scaled by
    # the final pow partial evaluation (round_verifier.rs:144-166)
    e0 = {name: np.array(v, dtype=object) for name, v in claimed.items()}
    subvals = evaluate_relations(e0, rp)
    alphas = [1] + list(rp["alphas"])
    total = 0
    for sub_idx, v in enumerate(subvals):
        v = int(v) % P
        if SUBRELATION_IS_LINEARLY_INDEPENDENT[sub_idx]:
            v = v * gs.partial_evaluation_result % P
        total = (total + v * alphas[sub_idx]) % P
    verified = verified and (total == target % P)
    return claimed, challenges, verified
