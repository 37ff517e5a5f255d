"""Plain PLONK verifier (snarkjs-compatible, host-side).

Parity: co-circom/co-plonk/src/plonk.rs:133-271 (which is
validated against committed snarkjs proofs). Pairing check:
    e(Wxi + u*Wxiw, x2) == e(xi*Wxi + u*xi*w*Wxiw + F - E, [1]_2)
"""

from __future__ import annotations

from ..fields.ec_host import ec_add, ec_mul, ec_neg
from ..ops.keccak import Keccak256Transcript
from ..pairing.pairing import engine
from ..pairing.tower import Tower


def _challenges(curve, vk, proof, publics):
    t = Keccak256Transcript(curve)
    for k in ("qm", "ql", "qr", "qo", "qc", "s1", "s2", "s3"):
        t.add_point(vk[k])
    for p in publics:
        t.add_scalar(p)
    t.add_point(proof["A"])
    t.add_point(proof["B"])
    t.add_point(proof["C"])
    beta = t.get_challenge()
    t = Keccak256Transcript(curve)
    t.add_scalar(beta)
    gamma = t.get_challenge()
    t = Keccak256Transcript(curve)
    t.add_scalar(beta)
    t.add_scalar(gamma)
    t.add_point(proof["Z"])
    alpha = t.get_challenge()
    t = Keccak256Transcript(curve)
    t.add_scalar(alpha)
    t.add_point(proof["T1"])
    t.add_point(proof["T2"])
    t.add_point(proof["T3"])
    xi = t.get_challenge()
    t = Keccak256Transcript(curve)
    t.add_scalar(xi)
    for k in ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2", "eval_zw"):
        t.add_scalar(proof[k])
    v = [t.get_challenge()]
    for _ in range(4):
        v.append(v[-1] * v[0] % curve.fr.p)
    t = Keccak256Transcript(curve)
    t.add_point(proof["Wxi"])
    t.add_point(proof["Wxiw"])
    u = t.get_challenge()
    return beta, gamma, alpha, xi, v, u


def verify_plonk(vk: dict, proof: dict, publics: list[int]) -> bool:
    curve = vk["curve"]
    p = curve.fr.p
    tw = Tower(curve)
    if len(publics) != vk["n_public"]:
        return False
    beta, gamma, alpha, xi, v, u = _challenges(curve, vk, proof, publics)
    power = vk["power"]
    n = 1 << power
    root = curve.fr.root_of_unity(power)

    xin = pow(xi, n, p)
    zh = (xin - 1) % p
    if zh == 0:
        return False
    l_len = max(1, len(publics))
    l = []
    w = 1
    for _ in range(l_len):
        l.append(w * zh % p * pow(n * (xi - w) % p, -1, p) % p)
        w = w * root % p
    pi = (-sum(le * pv for le, pv in zip(l, publics))) % p

    ea, eb, ec = proof["eval_a"], proof["eval_b"], proof["eval_c"]
    es1, es2, ezw = proof["eval_s1"], proof["eval_s2"], proof["eval_zw"]

    e2 = alpha * alpha % p * l[0] % p
    e3a = (ea + es1 * beta + gamma) % p
    e3b = (eb + es2 * beta + gamma) % p
    e3c = (ec + gamma) % p
    e3 = e3a * e3b % p * e3c % p * ezw % p * alpha % p
    r0 = (pi - e2 - e3) % p

    def lift(P):
        return None if P is None else (tw.fp(P[0]), tw.fp(P[1]))

    # D = Qm*(ab) + Ql*a + Qr*b + Qo*c + Qc + Z*(d2a+e2+u) - S3*(...) - T*zh
    d1 = ec_mul(lift(vk["qm"]), ea * eb % p)
    d1 = ec_add(d1, ec_mul(lift(vk["ql"]), ea))
    d1 = ec_add(d1, ec_mul(lift(vk["qr"]), eb))
    d1 = ec_add(d1, ec_mul(lift(vk["qo"]), ec))
    d1 = ec_add(d1, lift(vk["qc"]))

    betaxi = beta * xi % p
    d2a = (
        (ea + betaxi + gamma)
        * ((eb + betaxi * vk["k1"] + gamma) % p)
        % p
        * ((ec + betaxi * vk["k2"] + gamma) % p)
        % p
        * alpha
        % p
    )
    d2 = ec_mul(lift(proof["Z"]), (d2a + e2 + u) % p)
    d3 = ec_mul(lift(vk["s3"]), e3a * e3b % p * (alpha * beta % p * ezw % p) % p)
    d4 = ec_add(
        lift(proof["T1"]),
        ec_add(
            ec_mul(lift(proof["T2"]), xin), ec_mul(lift(proof["T3"]), xin * xin % p)
        ),
    )
    d4 = ec_mul(d4, zh)
    dpt = ec_add(ec_add(d1, d2), ec_neg(ec_add(d3, d4)))

    f = dpt
    f = ec_add(f, ec_mul(lift(proof["A"]), v[0]))
    f = ec_add(f, ec_mul(lift(proof["B"]), v[1]))
    f = ec_add(f, ec_mul(lift(proof["C"]), v[2]))
    f = ec_add(f, ec_mul(lift(vk["s1"]), v[3]))
    f = ec_add(f, ec_mul(lift(vk["s2"]), v[4]))

    e_scalar = (
        v[0] * ea + v[1] * eb + v[2] * ec + v[3] * es1 + v[4] * es2 + u * ezw - r0
    ) % p
    g1 = lift(curve.g1_gen)
    e_pt = ec_mul(g1, e_scalar)

    a1 = ec_add(lift(proof["Wxi"]), ec_mul(lift(proof["Wxiw"]), u))
    s = u * xi % p * root % p
    b1 = ec_add(
        ec_mul(lift(proof["Wxi"]), xi), ec_mul(lift(proof["Wxiw"]), s)
    )
    b1 = ec_add(b1, ec_add(ec_neg(e_pt), f))

    def as_ints(P):
        return None if P is None else (P[0].v, P[1].v)

    eng = engine(curve)
    neg_a1 = None if a1 is None else (a1[0].v, (-a1[1]).v)
    return eng.pairing_check(
        [(neg_a1, vk["x_2"]), (as_ints(b1), ((curve.g2_gen[0]), (curve.g2_gen[1])))]
    )
