# Frozen copy of cocircom_tpu_torch/pairing/tower.py (commit c520732), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""Host-side extension-field tower Fp -> Fp2 -> Fp6 -> Fp12 (python ints).

Used by the pairing-based verifiers (Groth16/PLONK `verify`) and as ground
truth for the Fq2 lane arithmetic. Tower:
    Fp2  = Fp[u]/(u^2 + 1)
    Fp6  = Fp2[v]/(v^3 - xi)       xi = curve.xi (9+u for BN254, 1+u for BLS)
    Fp12 = Fp6[w]/(w^2 - v)

Verifier-side only — speed is secondary, correctness primary. Reference
parity: arkworks ark-ec pairing usage in the upstream repository (SURVEY.md L0).
"""

from __future__ import annotations

from ..fields.params import CurveParams


class Fp:
    """Wrapper around int with field operators (uniform element protocol)."""

    __slots__ = ("v", "p")

    def __init__(self, v: int, p: int):
        self.v = v % p
        self.p = p

    def _new(self, v):
        return Fp(v, self.p)

    def __add__(self, o):
        return self._new(self.v + o.v)

    def __sub__(self, o):
        return self._new(self.v - o.v)

    def __mul__(self, o):
        return self._new(self.v * o.v)

    def __neg__(self):
        return self._new(-self.v)

    def sqr(self):
        return self._new(self.v * self.v)

    def inv(self):
        return self._new(pow(self.v, -1, self.p))

    def is_zero(self):
        return self.v == 0

    def conj(self):
        return self

    def __eq__(self, o):
        return isinstance(o, Fp) and self.v == o.v

    def __repr__(self):
        return f"Fp({self.v})"

    def zero(self):
        return self._new(0)

    def one(self):
        return self._new(1)

    def mul_int(self, k: int):
        return self._new(self.v * k)


class Fp2:
    """a = c0 + c1*u, u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp, c1: Fp):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o):
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        t = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2(v0 - v1, t - v0 - v1)

    def sqr(self):
        return self * self

    def conj(self):
        return Fp2(self.c0, -self.c1)

    def inv(self):
        norm = (self.c0.sqr() + self.c1.sqr()).inv()
        return Fp2(self.c0 * norm, -(self.c1 * norm))

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return isinstance(o, Fp2) and self.c0 == o.c0 and self.c1 == o.c1

    def __repr__(self):
        return f"Fp2({self.c0.v}, {self.c1.v})"

    def zero(self):
        return Fp2(self.c0.zero(), self.c0.zero())

    def one(self):
        return Fp2(self.c0.one(), self.c0.zero())

    def mul_int(self, k: int):
        return Fp2(self.c0.mul_int(k), self.c1.mul_int(k))

    def pow(self, e: int):
        return generic_pow(self, e)

    def frobenius(self):  # x -> x^p
        return self.conj()


class Fp6:
    """a = c0 + c1*v + c2*v^2, v^3 = xi."""

    __slots__ = ("c0", "c1", "c2", "xi")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2, xi: Fp2):
        self.c0, self.c1, self.c2, self.xi = c0, c1, c2, xi

    def _new(self, c0, c1, c2):
        return Fp6(c0, c1, c2, self.xi)

    def __add__(self, o):
        return self._new(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return self._new(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return self._new(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        v0, v1, v2 = a0 * b0, a1 * b1, a2 * b2
        c0 = v0 + self.xi * ((a1 + a2) * (b1 + b2) - v1 - v2)
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + self.xi * v2
        c2 = (a0 + a2) * (b0 + b2) - v0 - v2 + v1
        return self._new(c0, c1, c2)

    def sqr(self):
        return self * self

    def mul_by_v(self):
        """multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return self._new(self.xi * self.c2, self.c0, self.c1)

    def mul_int(self, k: int):
        return self._new(self.c0.mul_int(k), self.c1.mul_int(k), self.c2.mul_int(k))

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.sqr() - self.xi * (a1 * a2)
        t1 = self.xi * a2.sqr() - a0 * a1
        t2 = a1.sqr() - a0 * a2
        d = (a0 * t0 + self.xi * (a2 * t1) + self.xi * (a1 * t2)).inv()
        return self._new(t0 * d, t1 * d, t2 * d)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def zero(self):
        z = self.c0.zero()
        return self._new(z, z, z)

    def one(self):
        return self._new(self.c0.one(), self.c0.zero(), self.c0.zero())


class Fp12:
    """a = c0 + c1*w, w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp12(-self.c0, -self.c1)

    def __mul__(self, o):
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        c0 = v0 + v1.mul_by_v()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - v0 - v1
        return Fp12(c0, c1)

    def sqr(self):
        return self * self

    def conj(self):
        """x -> x^(p^6): (c0, c1) -> (c0, -c1)."""
        return Fp12(self.c0, -self.c1)

    def inv(self):
        d = (self.c0.sqr() - self.c1.sqr().mul_by_v()).inv()
        return Fp12(self.c0 * d, -(self.c1 * d))

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def one(self):
        return Fp12(self.c0.one(), self.c0.zero())

    def zero(self):
        return Fp12(self.c0.zero(), self.c0.zero())

    def pow(self, e: int):
        return generic_pow(self, e)

    def mul_int(self, k: int):
        return Fp12(self.c0.mul_int(k), self.c1.mul_int(k))


def generic_pow(base, e: int):
    if e < 0:
        return generic_pow(base.inv(), -e)
    acc = base.one()
    if e == 0:
        return acc
    for bit in bin(e)[2:]:
        acc = acc.sqr()
        if bit == "1":
            acc = acc * base
    return acc


class Tower:
    """Element constructors bound to one curve."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.p = curve.fq.p
        self.xi = self.fp2(*curve.xi)

    def fp(self, v: int) -> Fp:
        return Fp(v, self.p)

    def fp2(self, c0: int, c1: int) -> Fp2:
        return Fp2(self.fp(c0), self.fp(c1))

    def fp6(self, c0: Fp2, c1: Fp2, c2: Fp2) -> Fp6:
        return Fp6(c0, c1, c2, self.xi)

    def fp6_zero(self) -> Fp6:
        z = self.fp2(0, 0)
        return self.fp6(z, z, z)

    def fp12(self, c0: Fp6, c1: Fp6) -> Fp12:
        return Fp12(c0, c1)

    def fp12_one(self) -> Fp12:
        return Fp12(self.fp6_one(), self.fp6_zero())

    def fp6_one(self) -> Fp6:
        return self.fp6(self.fp2(1, 0), self.fp2(0, 0), self.fp2(0, 0))

    def fp2_to_fp12(self, x: Fp2) -> Fp12:
        c0 = self.fp6(x, self.fp2(0, 0), self.fp2(0, 0))
        return Fp12(c0, self.fp6_zero())

    def fp_to_fp12(self, x: int) -> Fp12:
        return self.fp2_to_fp12(self.fp2(x, 0))

    def w(self) -> Fp12:
        """The generator w of Fp12 over Fp6 (w^2 = v, w^6 = xi)."""
        return Fp12(self.fp6_zero(), self.fp6_one())
