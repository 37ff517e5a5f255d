# Frozen copy of cocircom_tpu_torch/honk/zeromorph.py (commit e513b03), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""ZeroMorph multilinear-to-univariate PCS (prover + verifier) and the
final KZG opening.

Parity: upstream co-noir/ultrahonk/src/decider/zeromorph/prover.rs
(multilinear quotients :19-55, batched lifted-degree quotient :70-95,
zeta_x :97-120, Z_x :140-178, zeromorph_prove :297-370), verifier.rs
(zeromorph_verify :51-105, C_zeta_x :108-140, C_Z_x :142-215), and
decider/prover.rs compute_opening_proof :24-40.

Polynomial order for batching (zeromorph/types.rs PolyF/PolyG/PolyGShift):
f = 27 precomputed + 8 witness entities; g = 4 tables + 5 to-be-shifted
wires; g-shift evaluations = 4 shifted tables + 5 shifted witnesses.
"""

from __future__ import annotations

from ..fields.ec_host import ec_add, ec_mul, ec_neg
from .builder import P
from .relations import (
    PRECOMPUTED_NAMES,
    SHIFTED_TABLE_NAMES,
    SHIFTED_WITNESS_NAMES,
    WITNESS_NAMES,
)
from .sumcheck import CONST_PROOF_SIZE_LOG_N

F_NAMES = PRECOMPUTED_NAMES + WITNESS_NAMES
G_NAMES = ("table_1", "table_2", "table_3", "table_4",
           "w_l", "w_r", "w_o", "w_4", "z_perm")
G_SHIFT_NAMES = SHIFTED_TABLE_NAMES + SHIFTED_WITNESS_NAMES


def _compute_multilinear_quotients(poly: list[int], u: list[int]):
    log_n = (len(poly)).bit_length() - 1
    quotients: list = [None] * log_n
    size_q = 1 << (log_n - 1)
    half_a, half_b = poly[:size_q], poly[size_q:]
    quotients[log_n - 1] = [(b - a) % P for a, b in zip(half_a, half_b)]
    g = half_a
    for k in range(1, log_n):
        index = log_n - k
        f_k = [(gi + u[index] * qi) % P
               for gi, qi in zip(g, quotients[index])]
        size_q >>= 1
        half_a, half_b = f_k[:size_q], f_k[size_q:]
        quotients[index - 1] = [(b - a) % P for a, b in zip(half_a, half_b)]
        g = f_k
    return quotients


def _batched_lifted_degree_quotient(quotients, y: int, n: int):
    result = [0] * n
    scalar = 1
    for k, q in enumerate(quotients):
        deg_k = (1 << k) - 1
        offset = n - deg_k - 1
        for i, qi in enumerate(q):
            result[offset + i] = (result[offset + i] + scalar * qi) % P
        scalar = scalar * y % P
    return result


def _partially_evaluated_degree_check(batched_q, quotients, y: int, x: int):
    n = len(batched_q)
    result = list(batched_q)
    y_pow = 1
    for k, q in enumerate(quotients):
        deg_k = (1 << k) - 1
        x_pow = pow(x, n - deg_k - 1, P)
        s = (-(y_pow * x_pow)) % P
        for i, qi in enumerate(q):
            result[i] = (result[i] + s * qi) % P
        y_pow = y_pow * y % P
    return result


def _partially_evaluated_zm_identity(f_batched, g_batched, quotients,
                                     v_eval: int, u: list[int], x: int):
    n = len(f_batched)
    result = list(g_batched)
    for i in range(n):
        result[i] = (result[i] + x * f_batched[i]) % P
    phi_numerator = (pow(x, n, P) - 1) % P
    phi_n_x = phi_numerator * pow(x - 1, -1, P) % P
    result[0] = (result[0] - v_eval * x % P * phi_n_x) % P
    for k, q in enumerate(quotients):
        x_power = pow(x, 1 << k, P)
        phi_1 = phi_numerator * pow(pow(x, 1 << (k + 1), P) - 1, -1, P) % P
        phi_2 = phi_numerator * pow(x_power - 1, -1, P) % P
        scalar = (x_power * phi_1 - phi_2 * u[k]) % P
        scalar = (-(scalar * x)) % P
        for i, qi in enumerate(q):
            result[i] = (result[i] + scalar * qi) % P
    return result


def zeromorph_prove(polys: dict, claimed: dict, challenges: list[int],
                    circuit_size: int, crs, transcript):
    """polys: full-length entity polynomials (unshifted); claimed: the
    sumcheck claimed evaluations (incl. shifted names). Returns the KZG
    opening claim (pi_polynomial, x_challenge)."""
    n = circuit_size
    log_n = n.bit_length() - 1
    u = challenges

    rho = transcript.get_challenge("rho")
    batched_eval = 0
    scalar = 1
    f_batched = [0] * n
    for name in F_NAMES:
        poly = polys[name]
        for i in range(n):
            f_batched[i] = (f_batched[i] + scalar * poly[i]) % P
        batched_eval = (batched_eval + scalar * claimed[name]) % P
        scalar = scalar * rho % P
    g_batched = [0] * n
    for name, shift_name in zip(G_NAMES, G_SHIFT_NAMES):
        poly = polys[name]
        for i in range(n):
            g_batched[i] = (g_batched[i] + scalar * poly[i]) % P
        batched_eval = (batched_eval + scalar * claimed[shift_name]) % P
        scalar = scalar * rho % P

    # f = f_batched + shift(g_batched)
    f_poly = list(f_batched)
    for i in range(n - 1):
        f_poly[i] = (f_poly[i] + g_batched[i + 1]) % P

    quotients = _compute_multilinear_quotients(f_poly, u)
    for idx, q in enumerate(quotients):
        transcript.send_point("ZM:C_q_%d" % idx, _pt_ints(crs.commit(q)))
    gen = _pt_ints(crs.g1)
    for idx in range(log_n, CONST_PROOF_SIZE_LOG_N):
        transcript.send_point("ZM:C_q_%d" % idx, gen)

    y = transcript.get_challenge("ZM:y")
    batched_q = _batched_lifted_degree_quotient(quotients, y, n)
    transcript.send_point("ZM:C_q", _pt_ints(crs.commit(batched_q)))

    x, z = transcript.get_challenges(["ZM:x", "ZM:z"])

    zeta_x = _partially_evaluated_degree_check(batched_q, quotients, y, x)
    z_x = _partially_evaluated_zm_identity(
        f_batched, g_batched, quotients, batched_eval, u, x)

    pi = [(a + z * b) % P for a, b in zip(zeta_x, z_x)]
    return pi, x


def compute_opening_proof(pi: list[int], x: int, crs, transcript):
    """KZG quotient for pi(X)/(X-x); evaluation is 0 (prover.rs:24-40)."""
    quotient = list(pi)
    # factor_roots: divide by (X - x) in place (polynomial.rs:120-138)
    if x == 0:
        quotient = quotient[1:]
    else:
        root_inv = pow(-x % P, -1, P)
        tmp = 0
        for i in range(len(quotient)):
            tmp = (quotient[i] - tmp) * root_inv % P
            quotient[i] = tmp
        quotient.pop()
    transcript.send_point("KZG:W", _pt_ints(crs.commit(quotient)))


def _pt_ints(pt):
    from .crs import g1_point_to_ints

    return g1_point_to_ints(pt)


# ------------------------------------------------------------- verifier

def zeromorph_verify(commitments: dict, claimed: dict, challenges: list[int],
                     circuit_size: int, transcript, g1_gen):
    """commitments: entity name -> host G1 affine (or None). Returns the
    opening claim (commitment C_zeta_z as host point, x_challenge)."""
    log_n = circuit_size.bit_length() - 1
    rho = transcript.get_challenge("rho")

    batched_eval = 0
    scalar = 1
    for name in list(F_NAMES) + list(G_SHIFT_NAMES):
        batched_eval = (batched_eval + claimed[name] * scalar) % P
        scalar = scalar * rho % P

    c_q_k = [transcript.receive_point("ZM:C_q_%d" % i)
             for i in range(CONST_PROOF_SIZE_LOG_N)]
    y = transcript.get_challenge("ZM:y")
    c_q = transcript.receive_point("ZM:C_q")
    x = transcript.get_challenge("ZM:x")
    z = transcript.get_challenge("ZM:z")

    n = circuit_size
    phi_numerator = (pow(x, n, P) - 1) % P
    phi_n_x = phi_numerator * pow(x - 1, -1, P) % P

    # C_zeta_x = C_q + sum_k (-y^k x^{n-d_k-1}) C_q_k
    acc = _from_ints(c_q)
    for k, c in enumerate(c_q_k):
        if k >= log_n:
            continue
        deg_k = (1 << k) - 1
        s = (-(pow(y, k, P) * pow(x, n - deg_k - 1, P))) % P
        acc = ec_add(acc, _mul_ints(c, s))
    c_zeta_x = acc

    # C_Z_x
    acc = ec_mul(g1_gen, (-(batched_eval * x % P * phi_n_x)) % P)
    rho_pow = 1
    for name in F_NAMES:
        acc = ec_add(acc, _mul_ints(commitments[name], x * rho_pow % P))
        rho_pow = rho_pow * rho % P
    for name in G_NAMES:
        acc = ec_add(acc, _mul_ints(commitments[name], rho_pow))
        rho_pow = rho_pow * rho % P
    x_pow_2k = x
    x_pow_2kp1 = x * x % P
    for k in range(CONST_PROOF_SIZE_LOG_N):
        if k >= log_n:
            continue
        phi_1 = phi_numerator * pow(x_pow_2kp1 - 1, -1, P) % P
        phi_2 = phi_numerator * pow(x_pow_2k - 1, -1, P) % P
        s = (x_pow_2k * phi_1 - challenges[k] * phi_2) % P
        s = (-(s * x)) % P
        acc = ec_add(acc, _mul_ints(c_q_k[k], s))
        x_pow_2k = x_pow_2kp1
        x_pow_2kp1 = x_pow_2kp1 * x_pow_2kp1 % P
    c_z_x = acc

    c_zeta_z = ec_add(c_zeta_x, ec_mul(c_z_x, z) if c_z_x else None)
    return c_zeta_z, x


def reduce_verify(opening_commitment, x: int, transcript, g1_gen):
    """decider/verifier.rs:24-45 -> (P0, P1) pairing points."""
    w = transcript.receive_point("KZG:W")
    w_pt = _from_ints(w)
    p1 = ec_neg(w_pt)
    p0 = ec_add(opening_commitment, ec_mul(w_pt, x))
    # evaluation is zero so no G1*eval subtraction term survives
    return p0, p1


def _from_ints(pt):
    from ..fields.params import BN254
    from ..pairing.tower import Fp

    if pt is None:
        return None
    return (Fp(pt[0], BN254.fq.p), Fp(pt[1], BN254.fq.p))


def _mul_ints(pt, s: int):
    if isinstance(pt, tuple) and pt and isinstance(pt[0], int):
        pt = _from_ints(pt)
    return ec_mul(pt, s % P) if pt is not None else None
