"""Plain Groth16 verifier (host-side pairing check).

Parity: co-circom/co-groth16/src/verifier.rs:23 (which wraps
ark-groth16's verify). Check:
    e(A, B) == e(alpha, beta) * e(L_pub, gamma) * e(C, delta)
with L_pub = IC_0 + sum_i pub_i * IC_{i+1}, done as a 4-term product-of-
pairings test against 1 (shared final exponentiation).
"""

from __future__ import annotations

from ..fields.ec_host import ec_add, ec_mul
from ..pairing.pairing import engine
from ..pairing.tower import Tower


def verify_groth16(vk: dict, proof: dict, public_inputs: list[int]) -> bool:
    curve = vk["curve"]
    if len(public_inputs) != vk["n_public"]:
        return False
    t = Tower(curve)
    e = engine(curve)

    def lift(P):
        return None if P is None else (t.fp(P[0]), t.fp(P[1]))

    acc = lift(vk["ic"][0])
    for x, Pj in zip(public_inputs, vk["ic"][1:]):
        acc = ec_add(acc, ec_mul(lift(Pj), x % curve.fr.p))
    if acc is None:
        l_pub = None
    else:
        l_pub = (acc[0].v, acc[1].v)

    neg_a = None if proof["pi_a"] is None else (proof["pi_a"][0], (-proof["pi_a"][1]) % curve.fq.p)
    return e.pairing_check(
        [
            (neg_a, proof["pi_b"]),
            (vk["alpha_1"], vk["beta_2"]),
            (l_pub, vk["gamma_2"]),
            (proof["pi_c"], vk["delta_2"]),
        ]
    )
