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

import torch

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
    """Factory bound to one driver; builds Pub/Sh wrappers.

    Eagerly every operator computes at once, a shared x shared product
    being one `mul_vec` round.  Inside `batched(fn)` the products of one
    multiplicative depth, across every formula fn evaluates, are ONE
    `mul_vec` round instead (see `_Schedule`)."""

    def __init__(self, driver):
        self.d = driver
        self.f = driver.fr
        self._const_cache: dict[int, object] = {}
        self.mul_elems = 0  # elements of the shared x shared products so far
        self._sched = None

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

    def _op(self, cls, fn, args, product: bool = False):
        """cls(fn(*values)) of one operator; a product's fn is None (the
        driver's `mul_vec`)."""
        if self._sched is not None:
            return self._sched.op(cls, fn, args, product)
        vals = [a.v for a in args]
        return cls(self, self._product(*vals) if product else fn(self, *vals))

    def _product(self, a, b):
        a, b = _pair(a, b)
        out = self.d.mul_vec(a, b)
        self.mul_elems += leaves(out)[0][0].numel()
        return out

    def batched(self, fn):
        """fn() (straight-line formulas over Pub/Sh wrappers: no branch on
        a value) with the shared products of each multiplicative depth as
        ONE driver `mul_vec`: the rounds of a whole evaluation are its
        depth, not its number of products.  Returns fn()'s result, every
        wrapper in it computed."""
        sched = _Schedule(self)
        self._sched = sched
        try:
            sched.trace(fn)
            out = None
            for step in range(sched.depth + 1):
                out = sched.run(fn, step)
        finally:
            self._sched = None
        return out


class _Schedule:
    """One `CoAlg.batched` evaluation.  fn() runs once to record its
    operators (each the k-th of the run, its inputs, whether it is a shared
    product), then once a step: step s computes the operators it is due,
    and after it the products of depth s + 1 run as one `mul_vec` over
    their operands laid end to end.  A product's depth is one more than its
    inputs' largest; any other operator's is its inputs' largest.  An
    operator is due at the last step its consumers allow (a product of
    depth k needs its inputs by step k - 1), so few results are held at
    once; a result is dropped as soon as its last consumer is computed.
    Operators are told apart by their place in the run, so fn must make
    the same operators in the same order each time."""

    def __init__(self, alg: CoAlg):
        self.alg = alg
        self.tracing = True
        self.inputs: list = []      # per operator: indices of its computed inputs
        self.product: list = []
        self.k = 0

    def trace(self, fn):
        self.k = 0
        out = fn()
        self.tracing = False
        n = len(self.inputs)
        keep = {w.i for w in _wrappers(out) if w.i is not None}
        depth = [0] * n
        for i, ins in enumerate(self.inputs):
            depth[i] = max((depth[j] for j in ins), default=0) + self.product[i]
        self.depth = max(depth, default=0)
        due = [self.depth] * n
        for i in range(n - 1, -1, -1):
            if self.product[i]:
                due[i] = depth[i] - 1
            for j in self.inputs[i]:
                due[j] = min(due[j], due[i])
        self.prod_depth = depth
        self.due = due
        self.uses = [0] * n
        for ins in self.inputs:
            for j in ins:
                self.uses[j] += 1
        for i in keep:
            self.uses[i] += 1      # results of fn() are never dropped
        self.done = [False] * n
        self.value: list = [None] * n

    def op(self, cls, fn, args, product):
        i = self.k
        self.k += 1
        alg = self.alg
        if self.tracing:
            self.inputs.append(tuple(a.i for a in args if a.i is not None))
            self.product.append(product)
            return cls(alg, None, i)
        if self.done[i]:
            return cls(alg, self.value[i], i)
        if product:
            if self.prod_depth[i] == self.step + 1:
                self.queue.append((i, args[0].v, args[1].v))
            return cls(alg, None, i)
        if self.due[i] != self.step:
            return cls(alg, None, i)
        v = fn(alg, *(a.v for a in args))
        self._finish(i, v)
        return cls(alg, v, i)

    def _finish(self, i, v):
        self.done[i] = True
        self.value[i] = v
        for j in self.inputs[i]:
            self.uses[j] -= 1
            if self.uses[j] == 0:
                self.value[j] = None

    def run(self, fn, step: int):
        self.k = 0
        self.step = step
        self.queue = []
        out = fn()
        if self.queue:
            self._flush()
        return out

    def _flush(self):
        """The queued products as one mul_vec over the operands, each
        broadcast to its product's shape and flattened, laid end to end."""
        alg, d = self.alg, self.alg.d
        xs, ys, shapes = [], [], []
        for _i, a, b in self.queue:
            a, b = _pair(a, b)
            la, lb = leaves(a)[0], leaves(b)[0]
            shape = (la.shape[0],) + tuple(torch.broadcast_shapes(la.shape[1:], lb.shape[1:]))
            shapes.append(shape)
            xs.append(pmap(lambda c, s=shape: c.expand(s).reshape(s[0], -1), a))
            ys.append(pmap(lambda c, s=shape: c.expand(s).reshape(s[0], -1), b))
        cat = (lambda *cs: torch.cat(cs, dim=1)) if len(xs) > 1 else (lambda c: c)
        x, y = pmap(cat, *xs), pmap(cat, *ys)
        del xs, ys
        out = d.mul_vec(x, y)
        del x, y
        lo = 0
        for (i, _a, _b), shape in zip(self.queue, shapes):
            size = 1
            for s in shape[1:]:
                size *= s
            self._finish(i, pmap(lambda c, lo=lo, size=size, s=shape:
                                 c[:, lo:lo + size].reshape(s), out))
            alg.mul_elems += size
            lo += size
        self.queue = []


def _wrappers(x):
    """The Pub/Sh wrappers in a (nested) list or tuple."""
    if isinstance(x, (Pub, Sh)):
        return [x]
    if isinstance(x, (list, tuple)):
        return [w for y in x for w in _wrappers(y)]
    return []


def _broadcastable(alg, other):
    """Coerce ints to Pub; pass wrappers; reject the rest."""
    if isinstance(other, (Pub, Sh)):
        return other
    if isinstance(other, int):
        return alg.pub_of_int(other)
    return NotImplemented


def _pub_add(alg, a, b):
    a, b = _pair(a, b)
    return alg.f.add(a, b)


def _pub_sub(alg, a, b):
    a, b = _pair(a, b)
    return alg.f.sub(a, b)


def _pub_mul(alg, a, b):
    a, b = _pair(a, b)
    return alg.f.mont_mul(a, b)


def _pub_neg(alg, a):
    return alg.f.neg(a)


def _sh_add(alg, a, b):
    a, b = _pair(a, b)
    return alg.d.add(a, b)


def _sh_add_pub(alg, a, b):
    a, b = _pair(a, b)
    return alg.d.add_public(a, b)


def _sh_sub(alg, a, b):
    a, b = _pair(a, b)
    return alg.d.sub(a, b)


def _sh_sub_pub(alg, a, b):
    a, b = _pair(a, b)
    return alg.d.add_public(a, alg.f.neg(b))


def _sh_mul_pub(alg, a, b):
    a, b = _pair(a, b)
    return alg.d.mul_public(a, b)


def _sh_neg(alg, a):
    return alg.d.neg(a)


class Pub:
    """A public value; `i` is its operator's place in a `batched` run
    (None outside one, or for a value made outside the formulas)."""

    __slots__ = ("alg", "v", "i")

    def __init__(self, alg: CoAlg, v, i=None):
        self.alg = alg
        self.v = v
        self.i = i

    def __mod__(self, _p):
        return self

    def __add__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        if isinstance(o, Sh):
            return o + self
        return self.alg._op(Pub, _pub_add, (self, o))

    __radd__ = __add__

    def __sub__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        if isinstance(o, Sh):
            return (-o) + self
        return self.alg._op(Pub, _pub_sub, (self, o))

    def __rsub__(self, o):
        return _broadcastable(self.alg, o) - self

    def __mul__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        if isinstance(o, Sh):
            return o * self
        return self.alg._op(Pub, _pub_mul, (self, o))

    __rmul__ = __mul__

    def __neg__(self):
        return self.alg._op(Pub, _pub_neg, (self,))


class Sh:
    """A share handle; `i` as for Pub."""

    __slots__ = ("alg", "v", "i")

    def __init__(self, alg: CoAlg, v, i=None):
        self.alg = alg
        self.v = v
        self.i = i

    def __mod__(self, _p):
        return self

    def __add__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        return self.alg._op(Sh, _sh_add if isinstance(o, Sh) else _sh_add_pub, (self, o))

    __radd__ = __add__

    def __sub__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        return self.alg._op(Sh, _sh_sub if isinstance(o, Sh) else _sh_sub_pub, (self, o))

    def __rsub__(self, o):
        return (-self) + _broadcastable(self.alg, o)

    def __mul__(self, o):
        o = _broadcastable(self.alg, o)
        if o is NotImplemented:
            return NotImplemented
        if isinstance(o, Sh):
            # ONE batched communication round over the whole tensor, or a
            # part of one under `batched`
            return self.alg._op(Sh, None, (self, o), product=True)
        return self.alg._op(Sh, _sh_mul_pub, (self, o))

    __rmul__ = __mul__

    def __neg__(self):
        return self.alg._op(Sh, _sh_neg, (self,))
