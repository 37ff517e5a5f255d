"""Public/shared tensor algebra for co-UltraHonk relation evaluation.

The plain relation formulas (relations.py) are written against numpy
object arrays with python-int semantics.  These wrappers give the SAME
formulas MPC semantics: `Pub` wraps a public (L, *batch) Montgomery limb
tensor, `Sh` wraps a driver share handle, and the operators dispatch —
public x public local, public x shared local scale, shared x shared one
batched driver mul round (the whole (L, 8, E) edge tensor in ONE round,
where the reference's co relations do a mul_many per edge,
co-ultrahonk co_decider/relations/*).

`x % P` is a no-op (field ops stay reduced), so `_m()` in relations.py
passes through.  Int literals are encoded to Montgomery constants lazily.
"""

from __future__ import annotations

from ..ops.curve import leaves, pmap
from .builder import P


def _nd(x):
    """ndim of a tensor or of a share's leaves."""
    return leaves(x)[0].dim()


def _align(v, target_nd: int):
    """Insert batch axes AFTER the limb axis so right-aligned broadcasting
    works: (L,) or (L, E) -> (L, 1, ..., E)."""

    def fix(c):
        while c.dim() < target_nd:
            c = c.unsqueeze(1)
        return c

    return pmap(fix, v)


def _pair(a, b):
    nd = max(_nd(a), _nd(b))
    return _align(a, nd), _align(b, nd)


class CoAlg:
    """Factory bound to one driver; builds Pub/Sh wrappers."""

    def __init__(self, driver):
        self.d = driver
        self.f = driver.fr
        self._const_cache: dict[int, object] = {}
        self.mul_elems = 0  # elements of the shared x shared products so far

    def const(self, v: int):
        v = int(v) % P
        if v not in self._const_cache:
            self._const_cache[v] = self.f.const_mont(v)  # (L,) Montgomery
        return self._const_cache[v]

    def pub_of_int(self, v: int) -> "Pub":
        return Pub(self, self.const(v))

    def pub(self, mont_tensor) -> "Pub":
        return Pub(self, mont_tensor)

    def sh(self, share) -> "Sh":
        return Sh(self, share)


def _broadcastable(alg, other):
    """Coerce ints to Pub; pass wrappers; reject the rest."""
    if isinstance(other, (Pub, Sh)):
        return other
    if isinstance(other, int):
        return alg.pub_of_int(other)
    return NotImplemented


class Pub:
    __slots__ = ("alg", "v")

    def __init__(self, alg: CoAlg, v):
        self.alg = alg
        self.v = v

    def __mod__(self, _p):
        return self

    def __add__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        if isinstance(o, Sh):
            return o + self
        a, b = _pair(self.v, o.v)
        return Pub(self.alg, self.alg.f.add(a, b))

    __radd__ = __add__

    def __sub__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        if isinstance(o, Sh):
            return (-o) + self
        a, b = _pair(self.v, o.v)
        return Pub(self.alg, self.alg.f.sub(a, b))

    def __rsub__(self, o):
        return _broadcastable(self.alg, o) - self

    def __mul__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        if isinstance(o, Sh):
            return o * self
        a, b = _pair(self.v, o.v)
        return Pub(self.alg, self.alg.f.mont_mul(a, b))

    __rmul__ = __mul__

    def __neg__(self):
        return Pub(self.alg, self.alg.f.neg(self.v))


class Sh:
    __slots__ = ("alg", "v")

    def __init__(self, alg: CoAlg, v):
        self.alg = alg
        self.v = v

    def __mod__(self, _p):
        return self

    def __add__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        d = self.alg.d
        a, b = _pair(self.v, o.v)
        if isinstance(o, Sh):
            return Sh(self.alg, d.add(a, b))
        return Sh(self.alg, d.add_public(a, b))

    __radd__ = __add__

    def __sub__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        d = self.alg.d
        a, b = _pair(self.v, o.v)
        if isinstance(o, Sh):
            return Sh(self.alg, d.sub(a, b))
        return Sh(self.alg, d.add_public(a, self.alg.f.neg(b)))

    def __rsub__(self, o):
        return (-self) + _broadcastable(self.alg, o)

    def __mul__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        d = self.alg.d
        a, b = _pair(self.v, o.v)
        if isinstance(o, Sh):
            # ONE batched communication round over the whole tensor
            out = d.mul_vec(a, b)
            self.alg.mul_elems += leaves(out)[0][0].numel()
            return Sh(self.alg, out)
        return Sh(self.alg, d.mul_public(a, b))

    __rmul__ = __mul__

    def __neg__(self):
        return Sh(self.alg, self.alg.d.neg(self.v))
