"""Elliptic-curve ops on torch tensors: branchless complete projective formulas.

Points are ``ProjPoint(x, y, z)`` whose coordinates are Montgomery limb
tensors ``(L, *batch)`` (G1) or pairs of them (G2 over Fq2).  Addition uses
the *complete* a=0 formulas (Renes-Costello-Batina 2016, Alg. 7), valid for
ALL inputs (identity, doubling, inverses).  Identity is (0 : 1 : 0).

`add` on CUDA tensors is ONE hand-written kernel (csrc/ec_add.cu `ec_add`
for G1 over Fq, csrc/ec_add_g2.cu `ec_add_g2` for G2 over Fq2).  The plain versions are taken
only for CPU tensors: `ec_add_plain` for G1 and `ec_add_g2_plain` for G2,
the three-wave stacked-multiply composition over `mont_mul_plain` and the
plain add and subtract.  The MSM's wave updates live here too: the mixed
add (csrc/ec_madd.cu, plain version `ec_madd_plain`) and the masked complete
add with per-lane negation, for G1 (csrc/ec_wave_add.cu, plain version
`ec_wave_add_plain`) and for G2 (csrc/ec_wave_add_g2.cu, plain version
`ec_wave_add_g2_plain`).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from ..fields.params import CurveParams
from . import kernels
from .field import Field, broadcast_shapes, get_field, mont_mul_plain


class ProjPoint(NamedTuple):
    x: Any
    y: Any
    z: Any


def pmap(fn, *pts):
    """Apply fn to every coordinate tensor of point(s): coordinates are
    tensors (G1) or pairs of tensors (G2).  Works on any tuple nest."""
    first = pts[0]
    if isinstance(first, torch.Tensor):
        return fn(*pts)
    out = [pmap(fn, *cs) for cs in zip(*pts)]
    return type(first)(*out) if hasattr(first, "_fields") else tuple(out)


def leaves(pt) -> list:
    if isinstance(pt, torch.Tensor):
        return [pt]
    return [t for c in pt for t in leaves(c)]


class FqLane:
    """Field-lane adapter over a base prime field (elements = tensors)."""

    def __init__(self, f: Field):
        self.f = f

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def mul(self, a, b):
        return self.f.mont_mul(a, b)

    def sqr(self, a):
        return self.f.mont_mul(a, a)

    def neg(self, a):
        return self.f.neg(a)

    def select(self, mask, a, b):
        return self.f.select(mask, a, b)

    def is_zero(self, a):
        return self.f.is_zero(a)

    def eq(self, a, b):
        return self.f.eq(a, b)

    def inv(self, a):
        return self.f.inv(a)

    def batch_inv(self, a, axis=1):
        return self.f.batch_inv(a, axis)

    def zeros(self, batch=()):
        return self.f.zeros(batch)

    def one(self, batch=()):
        return self.f.one_mont(batch)

    def const(self, v: int, nd: int = 0):
        """host int -> Montgomery constant broadcastable over nd batch dims."""
        return self.f.const_mont(v).reshape((self.f.L,) + (1,) * nd)

    def encode(self, vals):
        return self.f.encode(vals)

    def decode(self, a):
        return self.f.decode(a)

    def broadcast_to(self, a, batch):
        batch = tuple(batch)
        extra = len(batch) - (a.dim() - 1)
        a = a.reshape((self.f.L,) + (1,) * extra + tuple(a.shape[1:]))
        return a.expand((self.f.L,) + batch)

    def batch_shape(self, a):
        return tuple(a.shape[1:])

    def stack(self, elems, axis=1):
        return torch.stack(elems, dim=axis)

    def index(self, a, idx, axis=1):
        return a.select(axis, idx)


class Fq2Lane:
    """Quadratic extension lane: elements are (c0, c1) with u^2 = -1.  The
    two components of an add or subtract go through ONE base-field call
    (stacked on a new axis), which halves the small launches of the plain
    carry chains."""

    def __init__(self, f: Field):
        self.f = f

    def _mm(self, a, b):
        return self.f.mont_mul(a, b)

    def _pair(self, a, batch):
        return torch.stack([self._bt(a[0], batch), self._bt(a[1], batch)], dim=1)

    def _bt(self, c, batch):
        extra = len(batch) - (c.dim() - 1)
        c = c.reshape((self.f.L,) + (1,) * extra + tuple(c.shape[1:]))
        return c.expand((self.f.L,) + tuple(batch))

    def _batch2(self, a, b):
        return tuple(broadcast_shapes(a[0].shape[1:], b[0].shape[1:]))

    def add(self, a, b):
        batch = self._batch2(a, b)
        r = self.f.add(self._pair(a, batch), self._pair(b, batch))
        return (r[:, 0], r[:, 1])

    def sub(self, a, b):
        batch = self._batch2(a, b)
        r = self.f.sub(self._pair(a, batch), self._pair(b, batch))
        return (r[:, 0], r[:, 1])

    def mul(self, a, b):
        # Karatsuba with the 3 independent base products STACKED into one
        # mont_mul call
        f = self.f
        batch = self._batch2(a, b)
        a0, a1 = self._bt(a[0], batch), self._bt(a[1], batch)
        b0, b1 = self._bt(b[0], batch), self._bt(b[1], batch)
        s = f.add(torch.stack([a0, b0], dim=1), torch.stack([a1, b1], dim=1))
        lhs = torch.stack([a0, a1, s[:, 0]], dim=1)
        rhs = torch.stack([b0, b1, s[:, 1]], dim=1)
        prod = self._mm(lhs, rhs)
        v0, v1, t = prod[:, 0], prod[:, 1], prod[:, 2]
        d = f.sub(torch.stack([v0, t], dim=1), torch.stack([v1, v0], dim=1))
        return (d[:, 0], f.sub(d[:, 1], v1))

    def sqr(self, a):
        return self.mul(a, a)

    def neg(self, a):
        r = self.f.neg(torch.stack([a[0], a[1]], dim=1))
        return (r[:, 0], r[:, 1])

    def select(self, mask, a, b):
        return (self.f.select(mask, a[0], b[0]), self.f.select(mask, a[1], b[1]))

    def is_zero(self, a):
        return self.f.is_zero(a[0]) & self.f.is_zero(a[1])

    def eq(self, a, b):
        return self.f.eq(a[0], b[0]) & self.f.eq(a[1], b[1])

    def _norm(self, a):
        f = self.f
        sq = f.mont_mul(torch.stack([a[0], a[1]], dim=1), torch.stack([a[0], a[1]], dim=1))
        return f.add(sq[:, 0], sq[:, 1])

    def inv(self, a):
        ninv = self.f.inv(self._norm(a))
        return (self.f.mont_mul(a[0], ninv), self.f.neg(self.f.mont_mul(a[1], ninv)))

    def batch_inv(self, a, axis=1):
        ninv = self.f.batch_inv(self._norm(a), axis)
        return (self.f.mont_mul(a[0], ninv), self.f.neg(self.f.mont_mul(a[1], ninv)))

    def zeros(self, batch=()):
        return (self.f.zeros(batch), self.f.zeros(batch))

    def one(self, batch=()):
        return (self.f.one_mont(batch), self.f.zeros(batch))

    def const(self, v, nd: int = 0):
        shape = (self.f.L,) + (1,) * nd
        return (self.f.const_mont(v[0]).reshape(shape),
                self.f.const_mont(v[1]).reshape(shape))

    def encode(self, vals):
        """vals: sequence of (c0, c1) int pairs."""
        return (self.f.encode([v[0] for v in vals]), self.f.encode([v[1] for v in vals]))

    def decode(self, a):
        return (self.f.decode(a[0]), self.f.decode(a[1]))

    def broadcast_to(self, a, batch):
        return (self._bt(a[0], tuple(batch)), self._bt(a[1], tuple(batch)))

    def batch_shape(self, a):
        return tuple(a[0].shape[1:])

    def stack(self, elems, axis=1):
        return (torch.stack([e[0] for e in elems], dim=axis),
                torch.stack([e[1] for e in elems], dim=axis))

    def index(self, a, idx, axis=1):
        return (a[0].select(axis, idx), a[1].select(axis, idx))


class _PlainFq2Lane(Fq2Lane):
    """Fq2Lane whose multiply is `mont_mul_plain` on either device."""

    def _mm(self, a, b):
        return mont_mul_plain(self.f, a, b)


# ----------------------------------------------------------- plain versions

def ec_add_plain(f: Field, b3_mont: torch.Tensor, p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """Complete projective G1 add (RCB16 Alg. 7, a = 0) in plain torch: the
    same function as the CUDA kernel `ec_add`, either device.  The 14
    products run as three stacked `mont_mul_plain` calls."""
    batch = tuple(broadcast_shapes(p.x.shape[1:], q.x.shape[1:]))

    def bt(c):
        extra = len(batch) - (c.dim() - 1)
        return c.reshape((f.L,) + (1,) * extra + tuple(c.shape[1:])).expand((f.L,) + batch)

    x1, y1, z1 = (bt(c) for c in p)
    x2, y2, z2 = (bt(c) for c in q)
    st = lambda *cs: torch.stack(cs, dim=1)  # noqa: E731
    sums = f.add(st(x1, y1, x1, x2, y2, x2), st(y1, z1, z1, y2, z2, z2))
    w1 = mont_mul_plain(f, st(x1, y1, z1, sums[:, 0], sums[:, 1], sums[:, 2]),
                        st(x2, y2, z2, sums[:, 3], sums[:, 4], sums[:, 5]))
    m_xx, m_yy, m_zz = w1[:, 0], w1[:, 1], w1[:, 2]
    d = f.sub(f.sub(w1[:, 3:6], st(m_xx, m_yy, m_xx)), st(m_yy, m_zz, m_zz))
    t3, t4, xz = d[:, 0], d[:, 1], d[:, 2]
    t0 = f.add(f.add(m_xx, m_xx), m_xx)
    b3 = b3_mont.reshape((f.L,) + (1,) * (len(batch) + 1))
    w2 = mont_mul_plain(f, st(m_zz, xz), b3)
    t2, y3 = w2[:, 0], w2[:, 1]
    z3p = f.add(m_yy, t2)
    t1 = f.sub(m_yy, t2)
    w3 = mont_mul_plain(f, st(t3, t4, t1, y3, z3p, t0), st(t1, y3, z3p, t0, t4, t3))
    X3 = f.sub(w3[:, 0], w3[:, 1])
    yz = f.add(st(w3[:, 2], w3[:, 4]), st(w3[:, 3], w3[:, 5]))
    return ProjPoint(X3, yz[:, 0], yz[:, 1])


def ec_madd_plain(f: Field, acc: ProjPoint, rows, valid) -> ProjPoint:
    """Masked Jacobian += affine (madd-2007-bl) in plain torch: the same
    function as the CUDA kernel `ec_madd`, either device, out of place.
    rows (n, 2L): row i = [x limbs | y limbs]; (0, 0) is the identity;
    valid (n,) bool: False lanes pass through."""
    L = f.L
    batch = tuple(acc.x.shape[1:])
    X1, Y1, Z1 = (c.reshape(L, -1) for c in acc)
    t = rows.t()
    x2, y2 = t[:L], t[L:]
    keep = valid.reshape(-1) & ~((x2 == 0).all(dim=0) & (y2 == 0).all(dim=0))
    mul = lambda a, b: mont_mul_plain(f, a, b)  # noqa: E731
    add, sub = f.add, f.sub
    z1z1 = mul(Z1, Z1)
    u2 = mul(x2, z1z1)
    s2 = mul(y2, mul(Z1, z1z1))
    h = sub(u2, X1)
    hh = mul(h, h)
    i4 = add(add(hh, hh), add(hh, hh))
    j = mul(h, i4)
    r2 = sub(s2, Y1)
    r2 = add(r2, r2)
    v = mul(X1, i4)
    x3 = sub(sub(mul(r2, r2), j), add(v, v))
    y1j = mul(Y1, j)
    y3 = sub(mul(r2, sub(v, x3)), add(y1j, y1j))
    zh = add(Z1, h)
    z3 = sub(sub(mul(zh, zh), z1z1), hh)
    out = [torch.where(keep[None], n_, o_).reshape((L,) + batch)
           for n_, o_ in ((x3, X1), (y3, Y1), (z3, Z1))]
    return ProjPoint(*out)


def ec_wave_add_plain(f: Field, b3_mont: torch.Tensor, acc: ProjPoint, rows, neg,
                      valid) -> ProjPoint:
    """acc <- valid ? acc + (neg ? -pt : pt) : acc in plain torch: the same
    function as the CUDA kernel `ec_wave_add`, either device, out of place.
    rows (n, 3L): row i = [x | y | z limbs] of lane i's projective point;
    neg, valid (n,) bool.  Negate, `ec_add_plain`, select."""
    L = f.L
    batch = tuple(acc.x.shape[1:])
    t = rows.t()
    x2, y2, z2 = (t[k * L:(k + 1) * L].reshape((L,) + batch) for k in range(3))
    y2 = f.select(neg.reshape(batch), f.neg(y2), y2)
    added = ec_add_plain(f, b3_mont, acc, ProjPoint(x2, y2, z2))
    keep = valid.reshape(batch)
    return ProjPoint(*(f.select(keep, a, o) for a, o in zip(added, acc)))


def ec_add_g2_plain(ops: "CurveOps", p: ProjPoint, q: ProjPoint) -> ProjPoint:
    """Complete projective G2 add (RCB16 Alg. 7, a = 0) over Fq2 in plain
    torch: the same function as the CUDA kernel `ec_add_g2`, either device.
    The 12 Fq2 multiplies are regrouped into 3 stacked multiply waves
    (independent products batched along one axis into one `mont_mul_plain`
    call); the adds and subtracts between them are stacked likewise."""
    ln = _PlainFq2Lane(ops.lane.f)
    batch = tuple(broadcast_shapes(ln.batch_shape(p.x), ln.batch_shape(q.x)))
    X1, Y1, Z1 = (ln.broadcast_to(c, batch) for c in p)
    X2, Y2, Z2 = (ln.broadcast_to(c, batch) for c in q)
    st, ix = ln.stack, ln.index
    sums = ln.add(st([X1, Y1, X1, X2, Y2, X2]), st([Y1, Z1, Z1, Y2, Z2, Z2]))
    # wave 1: all pairwise products of the input coordinates
    l1 = st([X1, Y1, Z1, ix(sums, 0), ix(sums, 1), ix(sums, 2)])
    r1 = st([X2, Y2, Z2, ix(sums, 3), ix(sums, 4), ix(sums, 5)])
    w1 = ln.mul(l1, r1)
    m0, m1, m2 = ix(w1, 0), ix(w1, 1), ix(w1, 2)
    d = ln.sub(ln.sub(st([ix(w1, 3), ix(w1, 4), ix(w1, 5)]), st([m0, m1, m0])),
               st([m1, m2, m2]))
    t3, t4, y3p = ix(d, 0), ix(d, 1), ix(d, 2)  # X1Y2+X2Y1, Y1Z2+Y2Z1, X1Z2+X2Z1
    t0 = ln.add(ln.add(m0, m0), m0)  # 3 X1X2
    # wave 2: the two b3 scalings
    w2 = ln.mul(st([m2, y3p]), ops.b3(len(batch) + 1))
    t2, y3 = ix(w2, 0), ix(w2, 1)  # b3 Z1Z2, b3 (X1Z2+X2Z1)
    z3p = ln.add(m1, t2)
    t1 = ln.sub(m1, t2)
    # wave 3: the six output products
    w3 = ln.mul(st([t3, t4, t1, y3, z3p, t0]), st([t1, y3, z3p, t0, t4, t3]))
    X3 = ln.sub(ix(w3, 0), ix(w3, 1))
    yz = ln.add(st([ix(w3, 2), ix(w3, 4)]), st([ix(w3, 3), ix(w3, 5)]))
    return ProjPoint(X3, ix(yz, 0), ix(yz, 1))


def ec_wave_add_g2_plain(ops: "CurveOps", acc: ProjPoint, rows, neg, valid) -> ProjPoint:
    """acc <- valid ? acc + (neg ? -pt : pt) : acc over G2 in plain torch: the
    same function as the CUDA kernel `ec_wave_add_g2`, either device, out of
    place.  acc: coordinates are (c0, c1) pairs of (L, *batch) tensors; rows
    (n, 6L): row i = [x0 | x1 | y0 | y1 | z0 | z1 limbs] of lane i's point
    (the leaf order of the element-major point table); neg, valid (n,) bool.
    Negate, `ec_add_g2_plain`, select."""
    ln = ops.lane
    L = ln.f.L
    batch = ln.batch_shape(acc.x)
    t = rows.t()
    c = [t[k * L:(k + 1) * L].reshape((L,) + batch) for k in range(6)]
    y = ln.select(neg.reshape(batch), ln.neg((c[2], c[3])), (c[2], c[3]))
    added = ec_add_g2_plain(ops, acc, ProjPoint((c[0], c[1]), y, (c[4], c[5])))
    return ops.select(valid.reshape(batch), added, acc)


def ec_madd(f: Field, acc: ProjPoint, rows, valid) -> ProjPoint:
    """The MSM wave update.  On CUDA tensors the kernel updates `acc` IN
    PLACE (the caller owns it) and the same tensors are returned."""
    if acc.x.is_cuda:
        kernels.ec_madd(tuple(acc), rows, valid, f.kconsts)
        return acc
    return ec_madd_plain(f, acc, rows, valid)


def ec_wave_add(ops: "CurveOps", acc: ProjPoint, rows, neg, valid) -> ProjPoint:
    """The wave update of the complete-add MSM path (G1).  On CUDA tensors
    the kernel updates `acc` IN PLACE (the caller owns it) and the same
    tensors are returned."""
    if acc.x.is_cuda:
        kernels.ec_wave_add(tuple(acc), rows, neg, valid, ops._kconsts)
        return acc
    return ec_wave_add_plain(ops.lane.f, ops._b3_mont, acc, rows, neg, valid)


def ec_wave_add_g2(ops: "CurveOps", acc: ProjPoint, rows, neg, valid) -> ProjPoint:
    """The wave update of the complete-add MSM path over G2.  On CUDA
    tensors the kernel updates the six coordinate tensors of `acc` IN PLACE
    (the caller owns them) and the same point is returned."""
    if acc.x[0].is_cuda:
        kernels.ec_wave_add_g2(leaves(acc), rows, neg, valid, ops._kconsts)
        return acc
    return ec_wave_add_g2_plain(ops, acc, rows, neg, valid)


class CurveOps:
    """Complete-formula point arithmetic over a field lane."""

    def __init__(self, lane, b_host, name: str = "G", gen_host=None):
        self.lane = lane
        self.name = name
        self.b_host = b_host
        self.gen_host = gen_host  # host affine generator (bucket-init base)
        self.is_g2 = isinstance(b_host, tuple)
        self._b3_const: dict = {}
        f = lane.f
        if self.is_g2:
            self.b3_host = tuple((3 * c) % f.p for c in b_host)
            self._kconsts = f.kernel_consts(*((c * f.R) % f.p for c in self.b3_host))
        else:
            self.b3_host = (3 * b_host) % f.p
            b3_mont = (self.b3_host * f.R) % f.p
            self._b3_mont = f.const_mont(self.b3_host)
            self._kconsts = f.kernel_consts(b3_mont)

    def b3(self, nd: int = 0):
        if nd not in self._b3_const:
            self._b3_const[nd] = self.lane.const(self.b3_host, nd)
        return self._b3_const[nd]

    def identity(self, batch=()) -> ProjPoint:
        ln = self.lane
        return ProjPoint(ln.zeros(batch), pmap(lambda c: c.contiguous(), ln.one(batch)),
                         ln.zeros(batch))

    def is_identity(self, p: ProjPoint):
        return self.lane.is_zero(p.z)

    def neg(self, p: ProjPoint) -> ProjPoint:
        return ProjPoint(p.x, self.lane.neg(p.y), p.z)

    def select(self, mask, p: ProjPoint, q: ProjPoint) -> ProjPoint:
        ln = self.lane
        return ProjPoint(
            ln.select(mask, p.x, q.x), ln.select(mask, p.y, q.y), ln.select(mask, p.z, q.z)
        )

    def add(self, p: ProjPoint, q: ProjPoint) -> ProjPoint:
        """Renes-Costello-Batina 2016 Algorithm 7 (a=0), complete."""
        if not self.is_g2:
            if p.x.is_cuda or q.x.is_cuda:
                return ProjPoint(*kernels.ec_add(tuple(p), tuple(q), self._kconsts))
            return ec_add_plain(self.lane.f, self._b3_mont, p, q)
        if p.x[0].is_cuda or q.x[0].is_cuda:
            return ProjPoint(*kernels.ec_add_g2(tuple(p), tuple(q), self._kconsts))
        return ec_add_g2_plain(self, p, q)

    def double(self, p: ProjPoint) -> ProjPoint:
        return self.add(p, p)

    SCALAR_WINDOW = 4  # divides 32, so a window never straddles two limbs

    def scalar_mul(self, p: ProjPoint, scalar_limbs, nbits: int | None = None) -> ProjPoint:
        """p * s with s given as (Ls, *batch) 32-bit standard-form limbs
        (int32 bit patterns).  Fixed 4-bit windows from the top: a table of
        0..15 times p (built in three doubling steps on a trailing axis),
        then four doublings and one table add per window.  Branchless: the
        table entry is gathered per lane."""
        ln = self.lane
        W = self.SCALAR_WINDOW
        Ls = scalar_limbs.shape[0]
        nbits = nbits or 32 * Ls
        sb = tuple(scalar_limbs.shape[1:])
        batch = tuple(broadcast_shapes(ln.batch_shape(p.x), sb))
        p = ProjPoint(*(ln.broadcast_to(c, batch) for c in p))
        # table[..., k] = k * p
        tab = pmap(lambda o, c: torch.stack([o, c], dim=-1), self.identity(batch), p)
        for step in range(1, W):
            m = 1 << step
            top = self.double(pmap(lambda c: c[..., m // 2].contiguous(), tab))
            more = self.add(tab, pmap(lambda c: c.unsqueeze(-1), top))
            tab = pmap(lambda a, b: torch.cat([a, b], dim=-1), tab, more)
        tab = pmap(lambda c: c.contiguous(), tab)
        s64 = scalar_limbs.to(torch.int64) & 0xFFFFFFFF
        if sb != batch:
            s64 = s64.reshape((Ls,) + (1,) * (len(batch) - len(sb)) + sb).expand((Ls,) + batch)
        L = ln.f.L
        acc = None
        for i in range(-(-nbits // W) - 1, -1, -1):
            lo = W * i
            width = min(W, nbits - lo)
            digit = (s64[lo >> 5] >> (lo & 31)) & ((1 << width) - 1)
            idx = digit[None, ..., None].expand((L,) + batch + (1,))
            entry = pmap(lambda c: torch.gather(c, -1, idx).squeeze(-1), tab)
            if acc is None:
                acc = entry
                continue
            for _ in range(W):
                acc = self.double(acc)
            acc = self.add(acc, entry)
        return acc

    def suffix_sums(self, p: ProjPoint, axis: int = 1) -> ProjPoint:
        """out[i] = p[i] + p[i+1] + ... along one batch axis (masked
        Hillis-Steele: log2(n) batched adds)."""
        ln = self.lane
        batch = ln.batch_shape(p.x)
        n = batch[axis - 1]
        if n <= 1:
            return p
        steps = (n - 1).bit_length()
        pos_shape = tuple(d if i == axis - 1 else 1 for i, d in enumerate(batch))
        pos = torch.arange(n, device=leaves(p)[0].device).reshape(pos_shape).expand(batch)
        x = p
        for s in range(steps):
            shift = 1 << s
            rolled = pmap(lambda c: torch.roll(c, -shift, dims=axis), x)
            valid = (pos + shift) < n
            x = self.select(valid, self.add(x, rolled), x)
        return x

    def sum(self, p: ProjPoint, axis: int = 1) -> ProjPoint:
        """Reduce points along a batch axis (log2 adds via suffix_sums)."""
        s = self.suffix_sums(p, axis)
        return pmap(lambda a: a.select(axis, 0), s)

    # ---------------- host conversions ----------------

    def encode_points(self, affine_list) -> ProjPoint:
        """list of host affine points (None = infinity) -> batched ProjPoint."""
        ln = self.lane
        xs, ys, zs = [], [], []
        zero_c, one_c = ((0, 0), (1, 0)) if self.is_g2 else (0, 1)
        for pt in affine_list:
            if pt is None:
                xs.append(zero_c)
                ys.append(one_c)
                zs.append(zero_c)
            else:
                xs.append(pt[0])
                ys.append(pt[1])
                zs.append(one_c)
        return ProjPoint(ln.encode(xs), ln.encode(ys), ln.encode(zs))

    def decode_points(self, p: ProjPoint):
        """batched ProjPoint -> list of host affine points (None = infinity)."""
        ln = self.lane
        zinv = ln.batch_inv(p.z, axis=1)
        ax = ln.decode(ln.mul(p.x, zinv))
        ay = ln.decode(ln.mul(p.y, zinv))
        inf = self.is_identity(p).cpu().numpy()
        out = []
        for i in range(inf.shape[0]):
            if inf[i]:
                out.append(None)
            elif self.is_g2:
                out.append(((int(ax[0][i]), int(ax[1][i])), (int(ay[0][i]), int(ay[1][i]))))
            else:
                out.append((int(ax[i]), int(ay[i])))
        return out

    def to_affine_limbs(self, p: ProjPoint):
        """(x, y) affine Montgomery limbs; identity -> (0, 0)."""
        ln = self.lane
        batch = ln.batch_shape(p.x)
        if len(batch) == 0:
            zinv = ln.inv(p.z)
        else:
            zinv = ln.batch_inv(p.z, axis=1)
        inf = self.is_identity(p)
        ax = ln.mul(p.x, zinv)
        ay = ln.mul(p.y, zinv)
        zero = ln.zeros(batch)
        return (ln.select(inf, zero, ax), ln.select(inf, zero, ay))


@functools.lru_cache(maxsize=None)
def _g1_ops(curve: CurveParams, device) -> CurveOps:
    f = get_field(curve.fq.p, curve.name + ".fq", device)
    return CurveOps(FqLane(f), curve.b, curve.name + ".G1", curve.g1_gen)


@functools.lru_cache(maxsize=None)
def _g2_ops(curve: CurveParams, device) -> CurveOps:
    f = get_field(curve.fq.p, curve.name + ".fq", device)
    return CurveOps(Fq2Lane(f), curve.b2, curve.name + ".G2", curve.g2_gen)


def g1_ops(curve: CurveParams, device=None) -> CurveOps:
    from .field import resolve_device

    return _g1_ops(curve, resolve_device(device))


def g2_ops(curve: CurveParams, device=None) -> CurveOps:
    from .field import resolve_device

    return _g2_ops(curve, resolve_device(device))
