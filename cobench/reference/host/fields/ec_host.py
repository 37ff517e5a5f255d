# Frozen copy of cocircom_tpu_torch/fields/ec_host.py (commit c520732), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""Host-side affine elliptic-curve ops over generic tower elements.

Ground truth for the curve kernels and building block of the pairing
verifier. Points are ``None`` (infinity) or ``(x, y)`` tuples of tower
elements (Fp for G1, Fp2 for G2, Fp12 inside the Miller loop).
"""

from __future__ import annotations


def ec_add(P, Q):
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        # doubling, a=0: lambda = 3x^2 / 2y
        lam = x1.sqr().mul_int(3) * (y1 + y1).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.sqr() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def ec_neg(P):
    if P is None:
        return None
    return (P[0], -P[1])


def ec_double(P):
    return ec_add(P, P)


def ec_mul(P, k: int):
    if k < 0:
        return ec_mul(ec_neg(P), -k)
    acc = None
    while k:
        if k & 1:
            acc = ec_add(acc, P)
        P = ec_add(P, P)
        k >>= 1
    return acc


def ec_on_curve(P, b) -> bool:
    """y^2 == x^3 + b (a=0 curves)."""
    if P is None:
        return True
    x, y = P
    return (y.sqr() - (x.sqr() * x + b)).is_zero()


def ec_eq(P, Q) -> bool:
    if P is None or Q is None:
        return P is None and Q is None
    return P[0] == Q[0] and P[1] == Q[1]
