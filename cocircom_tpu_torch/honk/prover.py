"""UltraHonk prover: oink rounds + gate challenges + sumcheck + ZeroMorph.

Parity: upstream co-noir/ultrahonk/src/oink/prover.rs (full round
sequence :485-504, w4/memory records :52-92, logderiv inverses :144-178,
public input delta :180-226, grand product :273-313), prover.rs
(UltraHonk::prove :58-77), types.rs HonkProof buffer format :66-195.
"""

from __future__ import annotations

from .builder import P
from .crs import g1_point_to_ints
from .proving_key import (
    LOOKUP_READ_COUNTS,
    LOOKUP_READ_TAGS,
    Q_C,
    Q_LOOKUP,
    Q_M,
    Q_O,
    Q_R,
    TABLE_1,
    TABLE_2,
    TABLE_3,
    TABLE_4,
    ProvingKey,
)
from .relations import (
    ALL_ENTITY_NAMES,
    NUM_ALPHAS,
    PRECOMPUTED_NAMES,
)
from .sumcheck import CONST_PROOF_SIZE_LOG_N, sumcheck_prove
from .transcript import Transcript
from .zeromorph import compute_opening_proof, zeromorph_prove


def _batch_invert(vals: list[int]) -> list[int]:
    """Montgomery trick; zero entries stay zero (matches ark semantics)."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * (v if v else 1) % P
    inv = pow(prefix[n], -1, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        if vals[i]:
            out[i] = prefix[i] * inv % P
            inv = inv * vals[i] % P
    return out


def compute_public_input_delta(beta, gamma, public_inputs, circuit_size,
                               pub_inputs_offset):
    num = 1
    denom = 1
    num_acc = (gamma + (circuit_size + pub_inputs_offset) * beta) % P
    denom_acc = (gamma - (1 + pub_inputs_offset) * beta) % P
    for x in public_inputs:
        num = num * (num_acc + x) % P
        denom = denom * (denom_acc + x) % P
        num_acc = (num_acc + beta) % P
        denom_acc = (denom_acc - beta) % P
    return num * pow(denom, -1, P) % P


def _shifted(poly: list[int]) -> list[int]:
    return poly[1:] + [0]


def prove(pk: ProvingKey) -> list[int]:
    """Returns the proof as a flat list of Fr ints (HonkProof.inner)."""
    t = Transcript()
    n = pk.circuit_size
    crs = pk.crs

    # ---------------- oink preamble ----------------
    t.send_u64("circuit_size", n)
    t.send_u64("public_input_size", pk.num_public_inputs)
    t.send_u64("pub_inputs_offset", pk.pub_inputs_offset)
    assert pk.num_public_inputs == len(pk.public_inputs)
    for i, x in enumerate(pk.public_inputs):
        t.send_fr("public_input_%d" % i, x)

    w_l, w_r, w_o, w_4_base, read_counts, read_tags = pk.witness
    t.send_point("W_L", g1_point_to_ints(crs.commit(w_l)))
    t.send_point("W_R", g1_point_to_ints(crs.commit(w_r)))
    t.send_point("W_O", g1_point_to_ints(crs.commit(w_o)))

    # ---------------- sorted list accumulator ----------------
    eta_1, eta_2, eta_3 = t.get_challenges(["eta", "eta_two", "eta_three"])
    w_4 = list(w_4_base)
    for gate in pk.memory_read_records:
        w_4[gate] = (w_4[gate] + w_l[gate] * eta_1 + w_r[gate] * eta_2
                     + w_o[gate] * eta_3) % P
    for gate in pk.memory_write_records:
        w_4[gate] = (w_4[gate] + w_l[gate] * eta_1 + w_r[gate] * eta_2
                     + w_o[gate] * eta_3 + 1) % P
    t.send_point("LOOKUP_READ_COUNTS", g1_point_to_ints(crs.commit(read_counts)))
    t.send_point("LOOKUP_READ_TAGS", g1_point_to_ints(crs.commit(read_tags)))
    t.send_point("W_4", g1_point_to_ints(crs.commit(w_4)))

    # ---------------- log derivative inverses ----------------
    beta, gamma = t.get_challenges(["beta", "gamma"])
    pre = pk.precomputed
    w_l_shift, w_r_shift, w_o_shift = (_shifted(w_l), _shifted(w_r),
                                       _shifted(w_o))
    lookup_inverses = [0] * n
    for i in range(n):
        if not (pre[Q_LOOKUP][i] == 1 or read_tags[i] == 1):
            continue
        e1 = (w_l[i] + gamma + pre[Q_R][i] * w_l_shift[i]) % P
        e2 = (w_r[i] + pre[Q_M][i] * w_r_shift[i]) % P
        e3 = (w_o[i] + pre[Q_C][i] * w_o_shift[i]) % P
        read_term = (e1 + e2 * eta_1 + e3 * eta_2 + pre[Q_O][i] * eta_3) % P
        write_term = (pre[TABLE_1][i] + gamma + pre[TABLE_2][i] * eta_1
                      + pre[TABLE_3][i] * eta_2 + pre[TABLE_4][i] * eta_3) % P
        lookup_inverses[i] = read_term * write_term % P
    lookup_inverses = _batch_invert(lookup_inverses)
    t.send_point("LOOKUP_INVERSES", g1_point_to_ints(crs.commit(lookup_inverses)))

    # ---------------- grand product ----------------
    public_input_delta = compute_public_input_delta(
        beta, gamma, pk.public_inputs, n, pk.pub_inputs_offset)
    from .proving_key import ID_1, SIGMA_1

    numer = [0] * n
    denom = [0] * n
    wires4 = (w_l, w_r, w_o, w_4)
    for i in range(n):
        nv = 1
        dv = 1
        for col in range(4):
            w = wires4[col][i]
            nv = nv * (w + pre[ID_1 + col][i] * beta + gamma) % P
            dv = dv * (w + pre[SIGMA_1 + col][i] * beta + gamma) % P
        numer[i] = nv
        denom[i] = dv
    for i in range(1, n):
        numer[i] = numer[i] * numer[i - 1] % P
        denom[i] = denom[i] * denom[i - 1] % P
    denom = _batch_invert(denom)
    z_perm = [0] * n
    for i in range(1, n):
        z_perm[i] = numer[i - 1] * denom[i - 1] % P
    t.send_point("Z_PERM", g1_point_to_ints(crs.commit(z_perm)))

    alphas = [t.get_challenge("alpha_%d" % i) for i in range(NUM_ALPHAS)]

    # ---------------- gate challenges ----------------
    gate_challenges = [
        t.get_challenge("Sumcheck:gate_challenge_%d" % i)
        for i in range(CONST_PROOF_SIZE_LOG_N)
    ]

    # ---------------- assemble entity polynomials ----------------
    polys = {}
    for idx, name in enumerate(PRECOMPUTED_NAMES):
        polys[name] = pre[idx]
    polys["w_l"], polys["w_r"], polys["w_o"], polys["w_4"] = w_l, w_r, w_o, w_4
    polys["z_perm"] = z_perm
    polys["lookup_inverses"] = lookup_inverses
    polys["lookup_read_counts"] = read_counts
    polys["lookup_read_tags"] = read_tags
    polys["table_1_shift"] = _shifted(pre[TABLE_1])
    polys["table_2_shift"] = _shifted(pre[TABLE_2])
    polys["table_3_shift"] = _shifted(pre[TABLE_3])
    polys["table_4_shift"] = _shifted(pre[TABLE_4])
    polys["w_l_shift"], polys["w_r_shift"] = w_l_shift, w_r_shift
    polys["w_o_shift"] = w_o_shift
    polys["w_4_shift"] = _shifted(w_4)
    polys["z_perm_shift"] = _shifted(z_perm)
    assert set(polys) == set(ALL_ENTITY_NAMES)

    rp = {
        "eta_1": eta_1, "eta_2": eta_2, "eta_3": eta_3,
        "beta": beta, "gamma": gamma,
        "public_input_delta": public_input_delta,
        "alphas": alphas,
        "gate_challenges": gate_challenges,
    }

    # ---------------- sumcheck + zeromorph ----------------
    claimed, challenges = sumcheck_prove(polys, rp, n, t)
    pi, x = zeromorph_prove(polys, claimed, challenges, n, crs, t)
    compute_opening_proof(pi, x, crs, t)
    return t.proof_data


def proof_to_buffer(proof: list[int]) -> bytes:
    """HonkProof::to_buffer (types.rs:79-137): u32 BE count + 32-byte BE
    field elements."""
    out = bytearray()
    out += len(proof).to_bytes(4, "big")
    for el in proof:
        out += (el % P).to_bytes(32, "big")
    return bytes(out)


def proof_from_buffer(buf: bytes) -> list[int]:
    num = int.from_bytes(buf[:4], "big")
    if 4 + 32 * num != len(buf):
        raise ValueError("invalid proof length")
    return [int.from_bytes(buf[4 + 32 * i:36 + 32 * i], "big") % P
            for i in range(num)]
