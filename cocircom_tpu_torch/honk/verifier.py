"""UltraHonk verifier.

Parity: upstream co-noir/ultrahonk/src/verifier.rs :12-33,
oink/verifier.rs (round sequence :150-163), decider/verifier.rs
(verify :55-83, reduce_verify :24-45, pairing_check :47-53).
"""

from __future__ import annotations

from ..fields.params import BN254
from ..pairing.pairing import engine as pairing_engine
from ..pairing.tower import Fp
from .builder import P
from .crs import _g1_gen
from .prover import compute_public_input_delta
from .proving_key import VerifyingKey
from .relations import NUM_ALPHAS, PRECOMPUTED_NAMES
from .sumcheck import CONST_PROOF_SIZE_LOG_N, sumcheck_verify
from .transcript import Transcript
from .zeromorph import reduce_verify, zeromorph_verify


def _to_host_pt(xy):
    if xy is None:
        return None
    return (Fp(xy[0], BN254.fq.p), Fp(xy[1], BN254.fq.p))


def verify(proof: list[int], vk: VerifyingKey) -> bool:
    t = Transcript(proof)
    n = vk.circuit_size

    # ---------------- oink verify ----------------
    circuit_size = t.receive_u64("circuit_size")
    public_input_size = t.receive_u64("public_input_size")
    pub_inputs_offset = t.receive_u64("pub_inputs_offset")
    if circuit_size != vk.circuit_size:
        raise ValueError("proof circuit size does not match verification key")
    if public_input_size != vk.num_public_inputs:
        raise ValueError("public input size does not match verification key")
    if pub_inputs_offset != vk.pub_inputs_offset:
        raise ValueError("public input offset does not match verification key")
    public_inputs = [t.receive_fr("public_input_%d" % i)
                     for i in range(public_input_size)]

    comms: dict = {}
    comms["w_l"] = t.receive_point("W_L")
    comms["w_r"] = t.receive_point("W_R")
    comms["w_o"] = t.receive_point("W_O")
    eta_1, eta_2, eta_3 = t.get_challenges(["eta", "eta_two", "eta_three"])
    comms["lookup_read_counts"] = t.receive_point("lookup_read_counts")
    comms["lookup_read_tags"] = t.receive_point("lookup_read_tags")
    comms["w_4"] = t.receive_point("w_4")
    beta, gamma = t.get_challenges(["beta", "gamma"])
    comms["lookup_inverses"] = t.receive_point("lookup_inverses")
    public_input_delta = compute_public_input_delta(
        beta, gamma, public_inputs, n, vk.pub_inputs_offset)
    comms["z_perm"] = t.receive_point("z_perm")
    alphas = [t.get_challenge("alpha_%d" % i) for i in range(NUM_ALPHAS)]
    gate_challenges = [t.get_challenge("Sumcheck:gate_challenge_%d" % i)
                       for i in range(CONST_PROOF_SIZE_LOG_N)]

    rp = {
        "eta_1": eta_1, "eta_2": eta_2, "eta_3": eta_3,
        "beta": beta, "gamma": gamma,
        "public_input_delta": public_input_delta,
        "alphas": alphas,
        "gate_challenges": gate_challenges,
    }

    # ---------------- sumcheck verify ----------------
    claimed, challenges, sc_ok = sumcheck_verify(rp, n, t)
    if not sc_ok:
        return False

    # ---------------- zeromorph + KZG ----------------
    all_comms = dict(comms)
    for name, c in zip(PRECOMPUTED_NAMES, vk.commitments):
        from .crs import g1_point_to_ints

        all_comms[name] = g1_point_to_ints(c)
    host_comms = {k: _to_host_pt(v) if not _is_host(v) else v
                  for k, v in all_comms.items()}

    g1 = _g1_gen()
    c_zeta_z, x = zeromorph_verify(host_comms, claimed, challenges, n, t, g1)
    p0, p1 = reduce_verify(c_zeta_z, x, t, g1)

    # pairing engine consumes raw int coordinates
    eng = pairing_engine(BN254)
    g2_gen_ints = BN254.g2_gen
    return eng.pairing_check([
        (_g1_ints(p0), g2_gen_ints),
        (_g1_ints(p1), _g2_ints(vk.g2_x)),
    ])


def _is_host(v):
    return v is None or (isinstance(v, tuple) and hasattr(v[0], "p"))


def _g1_ints(pt):
    return None if pt is None else (pt[0].v, pt[1].v)


def _g2_ints(pt):
    return ((pt[0].c0.v, pt[0].c1.v), (pt[1].c0.v, pt[1].c1.v))
