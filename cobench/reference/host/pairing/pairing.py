# Frozen copy of cocircom_tpu_torch/pairing/pairing.py (commit c520732), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""Host-side optimal-ate pairing for BN254 and BLS12-381.

Powers the `verify` subcommand (plain verifier — no MPC, no accelerator needed), the
structural analogue of the reference's use of ark-ec pairings in
co-groth16/src/verifier.rs:23 and co-plonk's verifier.

Approach chosen for robustness over speed (it is verifier-side only):
G2 points are untwisted into E(Fp12) and the Miller loop runs with affine
line functions entirely in Fp12; Frobenius is computed as a plain p-power
exponentiation; the final exponentiation splits the easy part and computes
the hard part by integer exponentiation. Every step is generic over the
tower in pairing/tower.py.
"""

from __future__ import annotations

import functools

from ..fields.params import CurveParams
from .tower import Fp12, Tower, generic_pow


class PairingEngine:
    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.t = Tower(curve)
        self.p = curve.fq.p
        self.r = curve.fr.p
        if curve.name == "bn254":
            self.loop_count = 6 * curve.x + 2
            self.loop_is_negative = False
            self.bn_final_steps = True
        else:  # bls12_381
            self.loop_count = curve.x  # |x|; x_is_negative recorded separately
            self.loop_is_negative = curve.x_is_negative
            self.bn_final_steps = False

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------

    def embed_g1(self, P):
        """G1 affine ints (x, y) -> E(Fp12) point."""
        if P is None:
            return None
        x, y = P
        return (self.t.fp_to_fp12(x), self.t.fp_to_fp12(y))

    def untwist_g2(self, Q):
        """G2 affine Fq2 int-pairs ((x0,x1),(y0,y1)) -> E(Fp12) point."""
        if Q is None:
            return None
        (x0, x1), (y0, y1) = Q
        x = self.t.fp2_to_fp12(self.t.fp2(x0, x1))
        y = self.t.fp2_to_fp12(self.t.fp2(y0, y1))
        w = self.t.w()
        w2, w3 = w * w, w * w * w
        if self.curve.twist == "D":
            return (x * w2, y * w3)
        return (x * w2.inv(), y * w3.inv())

    def frobenius_pt(self, P):
        """(x, y) -> (x^p, y^p) on E(Fp12)."""
        return (P[0].pow(self.p), P[1].pow(self.p))

    # ------------------------------------------------------------------
    # Miller loop (affine line functions in Fp12)
    # ------------------------------------------------------------------

    def _line_double(self, T, P):
        xT, yT = T
        xP, yP = P
        lam = xT.sqr().mul_int(3) * (yT + yT).inv()
        x3 = lam.sqr() - xT - xT
        y3 = lam * (xT - x3) - yT
        ell = (yP - yT) - lam * (xP - xT)
        return (x3, y3), ell

    def _line_add(self, T, Q, P):
        xT, yT = T
        xQ, yQ = Q
        xP, yP = P
        if xT == xQ:
            if yT == yQ:
                return self._line_double(T, P)
            # vertical line x - xT
            return None, xP - xT
        lam = (yQ - yT) * (xQ - xT).inv()
        x3 = lam.sqr() - xT - xQ
        y3 = lam * (xT - x3) - yT
        ell = (yP - yT) - lam * (xP - xT)
        return (x3, y3), ell

    def miller_loop(self, P, Q) -> Fp12:
        """P: G1 affine ints; Q: G2 affine Fq2 int-pairs. Returns f (pre-exp)."""
        one = self.t.fp12_one()
        if P is None or Q is None:
            return one
        Pe = self.embed_g1(P)
        Qe = self.untwist_g2(Q)
        f = one
        T = Qe
        for bit in bin(self.loop_count)[3:]:
            T, ell = self._line_double(T, Pe)
            f = f.sqr() * ell
            if bit == "1":
                T, ell = self._line_add(T, Qe, Pe)
                f = f * ell
        if self.loop_is_negative:
            f = f.inv()
            T = (T[0], -T[1])
        if self.bn_final_steps:
            Q1 = self.frobenius_pt(Qe)
            Q2 = self.frobenius_pt(Q1)
            nQ2 = (Q2[0], -Q2[1])
            T, ell = self._line_add(T, Q1, Pe)
            f = f * ell
            _, ell = self._line_add(T, nQ2, Pe)
            f = f * ell
        return f

    # ------------------------------------------------------------------
    # final exponentiation
    # ------------------------------------------------------------------

    @functools.cached_property
    def _hard_exp(self) -> int:
        p = self.p
        return (p**4 - p**2 + 1) // self.r

    def final_exp(self, f: Fp12) -> Fp12:
        p = self.p
        # easy part: f^((p^6-1)(p^2+1))
        f1 = f.conj() * f.inv()  # f^(p^6 - 1)
        f2 = generic_pow(f1, p * p) * f1  # ^(p^2 + 1)
        # hard part: ^((p^4 - p^2 + 1)/r)
        return generic_pow(f2, self._hard_exp)

    def pairing(self, P, Q) -> Fp12:
        return self.final_exp(self.miller_loop(P, Q))

    def multi_pairing(self, pairs) -> Fp12:
        """prod_i e(P_i, Q_i): product of Miller loops, one final exp."""
        f = self.t.fp12_one()
        for P, Q in pairs:
            f = f * self.miller_loop(P, Q)
        return self.final_exp(f)

    def pairing_check(self, pairs) -> bool:
        return self.multi_pairing(pairs) == self.t.fp12_one()


@functools.lru_cache(maxsize=None)
def engine(curve: CurveParams) -> PairingEngine:
    return PairingEngine(curve)
