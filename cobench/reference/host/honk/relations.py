# Frozen copy of cocircom_tpu_torch/honk/relations.py (commit e513b03), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""The 8 Ultra relation families, evaluated batched.

Parity: upstream co-noir/ultrahonk/src/decider/relations/*
(ultra_arithmetic :128-190, permutation :40-100, delta_range :60-125,
elliptic :95-180, auxiliary :160-440, logderiv_lookup :68-230,
poseidon2_external :55-140, poseidon2_internal :60-145).

Formulas are written ONCE over numpy object arrays of ints mod p —
elementwise ops broadcast, so the same code serves:
  * the sumcheck prover: arrays shaped (8, E) — extension points x edges;
  * the sumcheck verifier: 0-d arrays (claimed evaluations).

Each evaluator returns the list of subrelation values IN ORDER; the
caller applies alphas / pow factors / scaling (round_prover.rs
batch_over_relations semantics). Subrelation count = 26, alphas = 25;
only lookup[1] is linearly DEPENDENT (no pow factor).

This module is the hot loop's formula source: the co-prover evaluates
the same formulas over (L, 8, E) Montgomery limb tensors by swapping the
array type (co_alg.Pub / co_alg.Sh); numpy-object is the byte-exact host
model.
"""

from __future__ import annotations

import numpy as np

from ..noir.poseidon2 import MAT_DIAG_M_1
from .builder import P

# entity key order = AllEntities iteration order (types.rs:196-217):
# 27 precomputed, 8 witness, 4 shifted tables, 5 shifted witness
PRECOMPUTED_NAMES = (
    "q_m", "q_c", "q_l", "q_r", "q_o", "q_4", "q_arith", "q_delta_range",
    "q_elliptic", "q_aux", "q_lookup", "q_poseidon2_external",
    "q_poseidon2_internal", "sigma_1", "sigma_2", "sigma_3", "sigma_4",
    "id_1", "id_2", "id_3", "id_4", "table_1", "table_2", "table_3",
    "table_4", "lagrange_first", "lagrange_last",
)
WITNESS_NAMES = ("w_l", "w_r", "w_o", "w_4", "z_perm", "lookup_inverses",
                 "lookup_read_counts", "lookup_read_tags")
SHIFTED_TABLE_NAMES = ("table_1_shift", "table_2_shift", "table_3_shift",
                       "table_4_shift")
SHIFTED_WITNESS_NAMES = ("w_l_shift", "w_r_shift", "w_o_shift", "w_4_shift",
                         "z_perm_shift")
ALL_ENTITY_NAMES = (PRECOMPUTED_NAMES + WITNESS_NAMES + SHIFTED_TABLE_NAMES
                    + SHIFTED_WITNESS_NAMES)
NUM_ALL_ENTITIES = len(ALL_ENTITY_NAMES)  # 44

NUM_SUBRELATIONS = 26
NUM_ALPHAS = NUM_SUBRELATIONS - 1
# index of the one linearly-dependent subrelation in the flat order below
SUBRELATION_IS_LINEARLY_INDEPENDENT = [True] * NUM_SUBRELATIONS
_LOOKUP_R1 = 2 + 2 + 4 + 2 + 6 + 1  # arith,perm,delta,elliptic,aux then r1
SUBRELATION_IS_LINEARLY_INDEPENDENT[_LOOKUP_R1] = False

# accumulator lengths per subrelation (relation Acc Univariate sizes);
# needed to truncate-then-extend exactly like the reference
SUBRELATION_LENGTHS = [
    6, 5,            # arithmetic
    6, 3,            # permutation
    6, 6, 6, 6,      # delta range
    6, 6,            # elliptic
    6, 6, 6, 6, 6, 6,  # auxiliary
    5, 5,            # logderiv lookup
    7, 7, 7, 7,      # poseidon2 external
    7, 7, 7, 7,      # poseidon2 internal
]

INV2 = pow(2, -1, P)
NEG_HALF = (-INV2) % P
LIMB_SIZE = (1 << 68) % P
SUBLIMB_SHIFT = 1 << 14
GRUMPKIN_MINUS_B = 17  # -curve_b, get_curve_b() = -17


def _m(x):
    return x % P


def evaluate_relations(e: dict, rp: dict):
    """e: entity name -> numpy object array (broadcastable); rp: relation
    params (eta_1, eta_2, eta_3, beta, gamma, public_input_delta — ints).
    Returns [26 subrelation value arrays] (pre-alpha, pre-pow)."""
    out = []
    for fn, _count, _selector in FAMILIES:
        out.extend(fn(e, rp))
    return out


def _arithmetic(e):
    q_arith = e["q_arith"]
    tmp = _m((q_arith - 3) * _m(e["q_m"] * e["w_r"] * e["w_l"]) * NEG_HALF)
    tmp = _m(tmp + _m(e["q_l"] * e["w_l"]) + _m(e["q_r"] * e["w_r"])
             + _m(e["q_o"] * e["w_o"]) + _m(e["q_4"] * e["w_4"]) + e["q_c"])
    tmp = _m(tmp + _m((q_arith - 1) * e["w_4_shift"]))
    r0 = _m(tmp * q_arith)

    tmp = _m(e["w_l"] + e["w_4"] - e["w_l_shift"] + e["q_m"])
    tmp = _m(tmp * (q_arith - 2))
    tmp = _m(tmp * (q_arith - 1))
    r1 = _m(tmp * q_arith)
    return [r0, r1]


def _permutation(e, rp):
    beta, gamma = rp["beta"], rp["gamma"]
    num = _m(e["w_l"] + _m(e["id_1"] * beta) + gamma)
    num = _m(num * _m(e["w_r"] + _m(e["id_2"] * beta) + gamma))
    num = _m(num * _m(e["w_o"] + _m(e["id_3"] * beta) + gamma))
    num = _m(num * _m(e["w_4"] + _m(e["id_4"] * beta) + gamma))
    den = _m(e["w_l"] + _m(e["sigma_1"] * beta) + gamma)
    den = _m(den * _m(e["w_r"] + _m(e["sigma_2"] * beta) + gamma))
    den = _m(den * _m(e["w_o"] + _m(e["sigma_3"] * beta) + gamma))
    den = _m(den * _m(e["w_4"] + _m(e["sigma_4"] * beta) + gamma))
    r0 = _m(_m((e["z_perm"] + e["lagrange_first"]) * num)
            - _m((_m(e["lagrange_last"] * rp["public_input_delta"])
                  + e["z_perm_shift"]) * den))
    r1 = _m(e["lagrange_last"] * e["z_perm_shift"])
    return [r0, r1]


def _delta_range(e):
    out = []
    deltas = [
        _m(e["w_r"] - e["w_l"]),
        _m(e["w_o"] - e["w_r"]),
        _m(e["w_4"] - e["w_o"]),
        _m(e["w_l_shift"] - e["w_4"]),
    ]
    for d in deltas:
        tmp = _m(_m(_m(d - 1) * _m(d - 1)) - 1)
        tmp = _m(tmp * _m(_m(_m(d - 2) * _m(d - 2)) - 1))
        out.append(_m(tmp * e["q_delta_range"]))
    return out


def _elliptic(e):
    x_1, y_1 = e["w_r"], e["w_o"]
    x_2, y_2 = e["w_l_shift"], e["w_4_shift"]
    x_3, y_3 = e["w_r_shift"], e["w_o_shift"]
    q_sign = e["q_l"]
    q_is_double = e["q_m"]

    x_diff = _m(x_2 - x_1)
    y2_sqr = _m(y_2 * y_2)
    y1_sqr = _m(y_1 * y_1)
    y1y2 = _m(y_1 * y_2 * q_sign)
    x_add_identity = _m(_m((x_3 + x_2 + x_1) * _m(x_diff * x_diff))
                        - y2_sqr - y1_sqr + y1y2 + y1y2)

    q_ell = e["q_elliptic"]
    q_ell_double = _m(q_ell * q_is_double)
    q_ell_not_double = _m(q_ell - q_ell_double)
    tmp1 = _m(x_add_identity * q_ell_not_double)

    y1_plus_y3 = _m(y_1 + y_3)
    y_diff = _m(_m(y_2 * q_sign) - y_1)
    y_add_identity = _m(_m(y1_plus_y3 * x_diff) + _m(_m(x_3 - x_1) * y_diff))
    tmp2 = _m(y_add_identity * q_ell_not_double)

    x1_mul_3 = _m(x_1 + x_1 + x_1)
    x_pow_4_mul_3 = _m(_m(y1_sqr + GRUMPKIN_MINUS_B) * x1_mul_3)
    y1_sqr_mul_4 = _m(y1_sqr * 4)
    x1_pow_4_mul_9 = _m(x_pow_4_mul_3 * 3)
    x_double_identity = _m(_m((x_3 + x_1 + x_1) * y1_sqr_mul_4) - x1_pow_4_mul_9)
    tmp1 = _m(tmp1 + _m(x_double_identity * q_ell_double))

    x1_sqr_mul_3 = _m(x1_mul_3 * x_1)
    y_double_identity = _m(_m(x1_sqr_mul_3 * _m(x_1 - x_3))
                           - _m(_m(y_1 + y_1) * y1_plus_y3))
    tmp2 = _m(tmp2 + _m(y_double_identity * q_ell_double))
    return [tmp1, tmp2]


def _auxiliary(e, rp):
    eta, eta_two, eta_three = rp["eta_1"], rp["eta_2"], rp["eta_3"]
    w_1, w_2, w_3, w_4 = e["w_l"], e["w_r"], e["w_o"], e["w_4"]
    w_1s, w_2s, w_3s, w_4s = (e["w_l_shift"], e["w_r_shift"], e["w_o_shift"],
                              e["w_4_shift"])
    q_1, q_2, q_3, q_4 = e["q_l"], e["q_r"], e["q_o"], e["q_4"]
    q_m, q_c, q_arith, q_aux = e["q_m"], e["q_c"], e["q_arith"], e["q_aux"]

    limb_subproduct = _m(_m(w_1 * w_2s) + _m(w_1s * w_2))
    nnf_gate_2 = _m(_m(w_1 * w_4) + _m(w_2 * w_3) - w_3s)
    nnf_gate_2 = _m(nnf_gate_2 * LIMB_SIZE)
    nnf_gate_2 = _m(nnf_gate_2 - w_4s)
    nnf_gate_2 = _m(nnf_gate_2 + limb_subproduct)
    nnf_gate_2 = _m(nnf_gate_2 * q_4)

    limb_subproduct = _m(limb_subproduct * LIMB_SIZE)
    limb_subproduct = _m(limb_subproduct + _m(w_1s * w_2s))
    nnf_gate_1 = _m(_m(limb_subproduct - _m(w_3 + w_4)) * q_3)
    nnf_gate_3 = _m(_m(limb_subproduct + w_4 - _m(w_3s + w_4s)) * q_m)
    nnf_identity = _m(_m(nnf_gate_1 + nnf_gate_2 + nnf_gate_3) * q_2)

    acc1 = _m(w_2s * SUBLIMB_SHIFT)
    acc1 = _m(_m(acc1 + w_1s) * SUBLIMB_SHIFT)
    acc1 = _m(_m(acc1 + w_3) * SUBLIMB_SHIFT)
    acc1 = _m(_m(acc1 + w_2) * SUBLIMB_SHIFT)
    acc1 = _m(acc1 + w_1 - w_4)
    acc1 = _m(acc1 * q_4)
    acc2 = _m(w_3s * SUBLIMB_SHIFT)
    acc2 = _m(_m(acc2 + w_2s) * SUBLIMB_SHIFT)
    acc2 = _m(_m(acc2 + w_1s) * SUBLIMB_SHIFT)
    acc2 = _m(_m(acc2 + w_4) * SUBLIMB_SHIFT)
    acc2 = _m(acc2 + w_3 - w_4s)
    acc2 = _m(acc2 * q_m)
    limb_acc_identity = _m(_m(acc1 + acc2) * q_3)

    memory_record_check = _m(w_3 * eta_three)
    memory_record_check = _m(memory_record_check + _m(w_2 * eta_two))
    memory_record_check = _m(memory_record_check + _m(w_1 * eta))
    memory_record_check = _m(memory_record_check + q_c)
    partial_record_check = memory_record_check
    memory_record_check = _m(memory_record_check - w_4)

    index_delta = _m(w_1s - w_1)
    record_delta = _m(w_4s - w_4)
    index_is_monotone = _m(_m(index_delta * index_delta) - index_delta)
    index_delta_one = _m(1 - index_delta)
    adjacent_match = _m(record_delta * index_delta_one)

    q_one_by_two = _m(q_1 * q_2)
    q_one_two_aux = _m(q_one_by_two * q_aux)
    r1 = _m(adjacent_match * q_one_two_aux)
    r2 = _m(q_one_two_aux * index_is_monotone)
    rom_consistency = _m(q_one_by_two * memory_record_check)

    access_type = _m(w_4 - partial_record_check)
    access_check = _m(_m(access_type * access_type) - access_type)

    next_gate_access = _m(w_3s * eta_three)
    next_gate_access = _m(next_gate_access + _m(w_2s * eta_two))
    next_gate_access = _m(next_gate_access + _m(w_1s * eta))
    next_gate_access = _m(w_4s - next_gate_access)

    value_delta = _m(w_3s - w_3)
    adjacent_match_read = _m(_m(value_delta * index_delta_one)
                             * _m(1 - next_gate_access))
    next_access_boolean = _m(_m(next_gate_access * next_gate_access)
                             - next_gate_access)

    q_arith_aux = _m(q_arith * q_aux)
    r3 = _m(adjacent_match_read * q_arith_aux)
    r4 = _m(index_is_monotone * q_arith_aux)
    r5 = _m(next_access_boolean * q_arith_aux)
    ram_consistency = _m(access_check * q_arith)

    timestamp_delta = _m(w_2s - w_2)
    ram_timestamp_check = _m(_m(index_delta_one * timestamp_delta) - w_3)

    memory_identity = rom_consistency
    memory_identity = _m(memory_identity
                         + _m(ram_timestamp_check * _m(q_4 * q_1)))
    memory_identity = _m(memory_identity
                         + _m(memory_record_check * _m(q_m * q_1)))
    memory_identity = _m(memory_identity + ram_consistency)

    r0 = _m(_m(memory_identity + nnf_identity + limb_acc_identity) * q_aux)
    return [r0, r1, r2, r3, r4, r5]


def _lookup(e, rp):
    gamma = rp["gamma"]
    eta_1, eta_2, eta_3 = rp["eta_1"], rp["eta_2"], rp["eta_3"]
    inverses = e["lookup_inverses"]
    read_counts = e["lookup_read_counts"]
    read_tags = e["lookup_read_tags"]
    q_lookup = e["q_lookup"]

    inverse_exists = _m(read_tags + q_lookup - _m(read_tags * q_lookup))

    d1 = _m(e["w_l"] + gamma + _m(e["q_r"] * e["w_l_shift"]))
    d2 = _m(_m(e["q_m"] * e["w_r_shift"]) + e["w_r"])
    d3 = _m(_m(e["q_c"] * e["w_o_shift"]) + e["w_o"])
    read_term = _m(d1 + _m(d2 * eta_1) + _m(d3 * eta_2) + _m(e["q_o"] * eta_3))

    write_term = _m(e["table_1"] + gamma + _m(e["table_2"] * eta_1)
                    + _m(e["table_3"] * eta_2) + _m(e["table_4"] * eta_3))

    write_inverse = _m(read_term * inverses)
    read_inverse = _m(write_term * inverses)

    r0 = _m(_m(read_term * write_term * inverses) - inverse_exists)
    r1 = _m(_m(read_inverse * q_lookup) - _m(write_inverse * read_counts))
    return [r0, r1]


def _poseidon_external(e):
    s = [_m(e["w_l"] + e["q_l"]), _m(e["w_r"] + e["q_r"]),
         _m(e["w_o"] + e["q_o"]), _m(e["w_4"] + e["q_4"])]
    u = []
    for si in s:
        v = _m(si * si)
        v = _m(v * v)
        u.append(_m(v * si))
    t0 = _m(u[0] + u[1])
    t1 = _m(u[2] + u[3])
    t2 = _m(u[1] + u[1] + t1)
    t3 = _m(u[3] + u[3] + t0)
    v4 = _m(_m(t1 * 4) + t3)
    v2 = _m(_m(t0 * 4) + t2)
    v1 = _m(t3 + v2)
    v3 = _m(t2 + v4)
    q = e["q_poseidon2_external"]
    return [_m(_m(v1 - e["w_l_shift"]) * q), _m(_m(v2 - e["w_r_shift"]) * q),
            _m(_m(v3 - e["w_o_shift"]) * q), _m(_m(v4 - e["w_4_shift"]) * q)]


def _poseidon_internal(e):
    s1 = _m(e["w_l"] + e["q_l"])
    u1 = _m(s1 * s1)
    u1 = _m(u1 * u1)
    u1 = _m(u1 * s1)
    u2, u3, u4 = e["w_r"], e["w_o"], e["w_4"]
    total = _m(u1 + u2 + u3 + u4)
    q = e["q_poseidon2_internal"]
    d = MAT_DIAG_M_1
    r0 = _m(_m(_m(u1 * d[0]) + total - e["w_l_shift"]) * q)
    r1 = _m(_m(_m(u2 * d[1]) + total - e["w_r_shift"]) * q)
    r2 = _m(_m(_m(u3 * d[2]) + total - e["w_o_shift"]) * q)
    r3 = _m(_m(_m(u4 * d[3]) + total - e["w_4_shift"]) * q)
    return [r0, r1, r2, r3]


# The relation families in subrelation order: (function of (e, rp), number
# of subrelations, the selector every one of its subrelations is a
# multiple of, or None).  Where that selector is zero on an edge, the
# family's values are zero there: the co-prover skips the family on a
# chunk of edges whose public selector is all zero, as upstream
# barretenberg skips a relation on such edges.
FAMILIES = (
    (lambda e, rp: _arithmetic(e), 2, "q_arith"),
    (_permutation, 2, None),
    (lambda e, rp: _delta_range(e), 4, "q_delta_range"),
    (lambda e, rp: _elliptic(e), 2, "q_elliptic"),
    (_auxiliary, 6, "q_aux"),
    (_lookup, 2, None),
    (lambda e, rp: _poseidon_external(e), 4, "q_poseidon2_external"),
    (lambda e, rp: _poseidon_internal(e), 4, "q_poseidon2_internal"),
)
