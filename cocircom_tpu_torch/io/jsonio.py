"""snarkjs-compatible JSON artifacts: proofs, verification keys, publics.

Parity: co-circom/circom-types/src/groth16/{proof,verification_key}.rs
and traits.rs g1/g2_from_strings_projective. Points are projective decimal
strings: G1 ["x","y","z"], G2 [["x0","x1"],["y0","y1"],["z0","z1"]].
"""

from __future__ import annotations

import json

from ..fields.params import CurveParams, curve_by_name


def g1_from_json(curve: CurveParams, v):
    x, y, z = (int(s) for s in v)
    if z == 0:
        return None
    fq = curve.fq
    if z != 1:
        zi = fq.inv(z)
        x, y = fq.mul(x, zi), fq.mul(y, zi)
    return (x % fq.p, y % fq.p)


def g2_from_json(curve: CurveParams, v):
    (x0, x1), (y0, y1), (z0, z1) = ((int(a), int(b)) for a, b in v)
    if z0 == 0 and z1 == 0:
        return None
    from ..pairing.tower import Tower

    t = Tower(curve)
    x, y, z = t.fp2(x0, x1), t.fp2(y0, y1), t.fp2(z0, z1)
    if not (z == t.fp2(1, 0)):
        zi = z.inv()
        x, y = x * zi, y * zi
    return ((x.c0.v, x.c1.v), (y.c0.v, y.c1.v))


def g1_to_json(P):
    if P is None:
        return ["0", "1", "0"]
    return [str(P[0]), str(P[1]), "1"]


def g2_to_json(P):
    if P is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    (x0, x1), (y0, y1) = P
    return [[str(x0), str(x1)], [str(y0), str(y1)], ["1", "0"]]


# ---------------------------------------------------------------- Groth16


def parse_groth16_proof(data: str | bytes | dict):
    d = data if isinstance(data, dict) else json.loads(data)
    curve = curve_by_name(d["curve"])
    return {
        "curve": curve,
        "pi_a": g1_from_json(curve, d["pi_a"]),
        "pi_b": g2_from_json(curve, d["pi_b"]),
        "pi_c": g1_from_json(curve, d["pi_c"]),
    }


def dump_groth16_proof(curve: CurveParams, pi_a, pi_b, pi_c) -> str:
    return json.dumps(
        {
            "pi_a": g1_to_json(pi_a),
            "pi_b": g2_to_json(pi_b),
            "pi_c": g1_to_json(pi_c),
            "protocol": "groth16",
            "curve": curve.circom_name,
        },
        indent=1,
    )


def parse_groth16_vk(data: str | bytes | dict):
    d = data if isinstance(data, dict) else json.loads(data)
    curve = curve_by_name(d["curve"])
    return {
        "curve": curve,
        "n_public": int(d["nPublic"]),
        "alpha_1": g1_from_json(curve, d["vk_alpha_1"]),
        "beta_2": g2_from_json(curve, d["vk_beta_2"]),
        "gamma_2": g2_from_json(curve, d["vk_gamma_2"]),
        "delta_2": g2_from_json(curve, d["vk_delta_2"]),
        "ic": [g1_from_json(curve, p) for p in d["IC"]],
    }


def dump_groth16_vk(vk: dict) -> str:
    """snarkjs verification_key.json format (inverse of parse_groth16_vk)."""
    return json.dumps(
        {
            "protocol": "groth16",
            "curve": vk["curve"].circom_name,
            "nPublic": vk["n_public"],
            "vk_alpha_1": g1_to_json(vk["alpha_1"]),
            "vk_beta_2": g2_to_json(vk["beta_2"]),
            "vk_gamma_2": g2_to_json(vk["gamma_2"]),
            "vk_delta_2": g2_to_json(vk["delta_2"]),
            "IC": [g1_to_json(p) for p in vk["ic"]],
        },
        indent=1,
    )


def parse_public_inputs(data: str | bytes) -> list[int]:
    return [int(s) for s in json.loads(data)]


def dump_public_inputs(vals) -> str:
    return json.dumps([str(int(v)) for v in vals], indent=1)


# ---------------------------------------------------------------- PLONK


def parse_plonk_vk(data: str | bytes | dict):
    d = data if isinstance(data, dict) else json.loads(data)
    curve = curve_by_name(d["curve"])
    return {
        "curve": curve,
        "n_public": int(d["nPublic"]),
        "power": int(d["power"]),
        "k1": int(d["k1"]),
        "k2": int(d["k2"]),
        "qm": g1_from_json(curve, d["Qm"]),
        "ql": g1_from_json(curve, d["Ql"]),
        "qr": g1_from_json(curve, d["Qr"]),
        "qo": g1_from_json(curve, d["Qo"]),
        "qc": g1_from_json(curve, d["Qc"]),
        "s1": g1_from_json(curve, d["S1"]),
        "s2": g1_from_json(curve, d["S2"]),
        "s3": g1_from_json(curve, d["S3"]),
        "x_2": g2_from_json(curve, d["X_2"]),
    }


def dump_plonk_vk(vk: dict) -> str:
    """snarkjs plonk verification_key.json (inverse of parse_plonk_vk)."""
    return json.dumps(
        {
            "protocol": "plonk",
            "curve": vk["curve"].circom_name,
            "nPublic": vk["n_public"],
            "power": vk["power"],
            "k1": str(vk["k1"]),
            "k2": str(vk["k2"]),
            "Qm": g1_to_json(vk["qm"]),
            "Ql": g1_to_json(vk["ql"]),
            "Qr": g1_to_json(vk["qr"]),
            "Qo": g1_to_json(vk["qo"]),
            "Qc": g1_to_json(vk["qc"]),
            "S1": g1_to_json(vk["s1"]),
            "S2": g1_to_json(vk["s2"]),
            "S3": g1_to_json(vk["s3"]),
            "X_2": g2_to_json(vk["x_2"]),
        },
        indent=1,
    )


def parse_plonk_proof(data: str | bytes | dict):
    d = data if isinstance(data, dict) else json.loads(data)
    curve = curve_by_name(d["curve"])
    out = {"curve": curve}
    for k in ("A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw"):
        out[k] = g1_from_json(curve, d[k])
    for k in ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2", "eval_zw"):
        out[k] = int(d[k])
    return out


def dump_plonk_proof(curve: CurveParams, proof: dict) -> str:
    d = {}
    for k in ("A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw"):
        d[k] = g1_to_json(proof[k])
    for k in ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2", "eval_zw"):
        d[k] = str(int(proof[k]))
    d["protocol"] = "plonk"
    d["curve"] = curve.circom_name
    return json.dumps(d, indent=1)
