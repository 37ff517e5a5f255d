"""Collaborative Groth16 prover — written once, generic over the MPC driver.

Parity: co-circom/co-groth16/src/groth16.rs:113-326.
Communication rounds (REP3): 2 vector rounds in the witness map (mul_vec),
then mul(r,s), open_point(g_a), scalar_mul(g1_b, r), open_two_points — the
~5-round endgame of the reference, all batched.

All heavy compute (constraint evaluation = gather + segment-sum, 6 NTTs,
5 MSMs) runs on the driver's device through its field/curve engines.  The
three phases are timed as tracer spans (utils/trace.py); with a tracer that
has `sync` set, each span ends with a device synchronize so the split is
device time and not enqueue time.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from ..io.zkey import Groth16ZKey
from ..ops.curve import ProjPoint, pmap

SPAN_WITNESS_MAP = "witness_map (constraints+iFFT/coset/FFT)"
SPAN_MSM_HL = "MSM h_query + l_query"
SPAN_ENDGAME = "A/B coefficient MSMs + open endgame"


class SharedWitness(NamedTuple):
    """public_inputs[0] == 1; witness = driver share-vec of aux signals
    (parity: co-circom-snarks/src/lib.rs:24-41)."""

    public_inputs: list
    witness: Any


def _slice_points(pt: ProjPoint, lo: int, hi: int) -> ProjPoint:
    return pmap(lambda c: c[..., lo:hi], pt)


def _point_at(pt: ProjPoint, i: int) -> ProjPoint:
    return pmap(lambda c: c[..., i], pt)


def _expand(pt: ProjPoint) -> ProjPoint:
    return pmap(lambda c: c.unsqueeze(-1), pt)


class CoGroth16:
    def __init__(self, driver, tracer=None):
        from ..utils.trace import tracer_or_null

        self.driver = driver
        self.tracer = tracer_or_null(tracer)

    # ------------------------------------------------------------------

    def _eval_matrix(self, rows, cols, coeffs, z, domain_size: int):
        d = self.driver
        gathered = d.gather(z, cols)
        prods = d.mul_public(gathered, coeffs)
        return d.segment_sum(prods, rows, domain_size)

    def witness_map_from_matrices(self, zkey: Groth16ZKey, pub_mont, witness):
        d = self.driver
        m = zkey.matrices
        num_constraints = m.num_constraints
        domain_size = zkey.domain_size

        z = d.concat(d.promote_public(pub_mont), witness)
        a = self._eval_matrix(m.a_rows, m.a_cols, m.a_coeffs, z, domain_size)
        b = self._eval_matrix(m.b_rows, m.b_cols, m.b_coeffs, z, domain_size)
        a = d.set_slice(a, num_constraints, d.promote_public(pub_mont))

        c = d.mul_vec(a, b)  # round 1
        a = d.fft(d.coset_shift(d.ifft(a)))
        b = d.fft(d.coset_shift(d.ifft(b)))
        ab = d.mul_vec(a, b)  # round 2
        c = d.fft(d.coset_shift(d.ifft(c)))
        return d.sub(ab, c)

    # ------------------------------------------------------------------

    def _calculate_coeff(self, initial, query_proj, vk_param_host, pub_ints, witness, g2=False):
        """groth16.rs:204-234: initial + query[0] + vk_param + MSM(pub) + MSM(priv)."""
        d = self.driver
        ops = d.g2 if g2 else d.g1
        eng = d.msm_g2_engine if g2 else d.msm_g1_engine
        pub_len = len(pub_ints)
        pub_scal = d.fr.to_limbs([int(x) % d.fr.p for x in pub_ints])
        pub_acc = eng.msm(_slice_points(query_proj, 1, 1 + pub_len), pub_scal)
        priv = pmap(lambda c: c[..., 1 + pub_len:], query_proj)
        priv_acc = (d.msm_g2 if g2 else d.msm_g1)(priv, witness)

        res = initial
        res = d.point_add_public(ops, res, _point_at(query_proj, 0))
        res = d.point_add_public(ops, res, _point_at((d.host_g2 if g2 else d.host_g1)(vk_param_host), 0))
        res = d.point_add_public(ops, res, pub_acc)
        res = d.point_add(ops, res, priv_acc)
        return res

    def prove(self, zkey: Groth16ZKey, shared: SharedWitness) -> dict:
        d = self.driver
        pub = shared.public_inputs
        assert int(pub[0]) == 1, "public_inputs[0] must be the constant 1"
        pub_mont = d.encode_publics(pub)

        tr = self.tracer
        with tr.span(SPAN_WITNESS_MAP):
            h = self.witness_map_from_matrices(zkey, pub_mont, shared.witness)
        r = d.rand(())
        s = d.rand(())

        # MSMs over zkey queries
        with tr.span(SPAN_MSM_HL):
            h_acc = d.msm_g1(d.g1_proj(zkey.h_query), h)
            l_aux = d.msm_g1(d.g1_proj(zkey.l_query), shared.witness)

        delta_g1 = _point_at(d.host_g1(zkey.delta_g1), 0)
        rs = d.mul(r, s)  # round
        r_s_delta = d.scalar_mul_public_point(d.g1, delta_g1, rs)

        pub_rest = [int(x) for x in pub[1:]]
        tr_ctx = tr.span(SPAN_ENDGAME)
        tr_ctx.__enter__()
        a_query = d.g1_proj(zkey.a_query)
        r_delta = d.scalar_mul_public_point(d.g1, delta_g1, r)
        g_a = self._calculate_coeff(r_delta, a_query, zkey.alpha_g1, pub_rest, shared.witness)
        g_a_open = d.open_point(d.g1, g_a)  # round
        s_g_a = d.scalar_mul_public_point(d.g1, g_a_open, s)

        s_delta = d.scalar_mul_public_point(d.g1, delta_g1, s)
        g1_b = self._calculate_coeff(
            s_delta, d.g1_proj(zkey.b_g1_query), zkey.beta_g1, pub_rest, shared.witness
        )
        r_g1_b = d.scalar_mul(d.g1, g1_b, r)  # round

        delta_g2 = _point_at(d.host_g2(zkey.delta_g2), 0)
        s_delta_g2 = d.scalar_mul_public_point(d.g2, delta_g2, s)
        g2_b = self._calculate_coeff(
            s_delta_g2, d.g2_proj(zkey.b_g2_query), zkey.beta_g2, pub_rest,
            shared.witness, g2=True,
        )

        g_c = s_g_a
        g_c = d.point_add(d.g1, g_c, r_g1_b)
        g_c = d.point_sub(d.g1, g_c, r_s_delta)
        g_c = d.point_add(d.g1, g_c, l_aux)
        g_c = d.point_add(d.g1, g_c, h_acc)

        g_c_open, g2_b_open = d.open_two_points(g_c, g2_b)  # round
        tr_ctx.__exit__(None, None, None)

        pi_a = d.g1.decode_points(_expand(g_a_open))[0]
        pi_b = d.g2.decode_points(_expand(g2_b_open))[0]
        pi_c = d.g1.decode_points(_expand(g_c_open))[0]
        return {"curve": d.curve, "pi_a": pi_a, "pi_b": pi_b, "pi_c": pi_c}
