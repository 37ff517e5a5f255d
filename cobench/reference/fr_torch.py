"""Exact arithmetic in a prime field of at most 255 bits in plain PyTorch,
for the reference's witness map on the card (or the CPU at small sizes).

An element is 16 limbs of 16 bits, least significant first, each in an
int64, limb first: a (16, ...) tensor.  Products are kept in Montgomery form
with R = 2^256 and reduced word by word; a column of a product sums at most
16 products of 16-bit limbs and 16 of the modulus's, so it stays far below
2^63.  Nothing here is the program's: it is the schoolbook method, written
for the reference alone.
"""

from __future__ import annotations

import numpy as np

LIMBS = 16
BITS = 16
MASK = (1 << BITS) - 1


def int_limbs(v: int) -> list:
    return [(v >> (BITS * k)) & MASK for k in range(LIMBS)]


def bit_reverse(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


class Field:
    def __init__(self, p: int, device):
        import torch

        assert p < 1 << (LIMBS * BITS - 1)
        self.torch, self.p, self.device = torch, p, device
        self.P = self.limbs([p])
        self.pinv = (-pow(p, -1, 1 << BITS)) % (1 << BITS)
        self.R = pow(2, LIMBS * BITS, p)
        self.R2 = self.limbs([self.R * self.R % p])
        self.ONE = self.limbs([1])

    # ------------------------------------------------------------ moving

    def limbs(self, values) -> "torch.Tensor":
        """(16, n) limbs of the ints `values` (each below 2^256)."""
        rows = np.array([int_limbs(int(v)) for v in values], dtype=np.int64).reshape(-1, LIMBS)
        return self.torch.from_numpy(rows.T.copy()).to(self.device)

    def from_u32(self, raw) -> "torch.Tensor":
        """(16, n) limbs of (L, n) 32-bit limbs, least significant first, as
        int32 or int64 (read as unsigned)."""
        torch = self.torch
        u = raw.to(torch.int64) & 0xFFFFFFFF
        out = torch.zeros((LIMBS, u.shape[1]), dtype=torch.int64, device=u.device)
        for k in range(min(u.shape[0], LIMBS // 2)):
            out[2 * k] = u[k] & MASK
            out[2 * k + 1] = u[k] >> BITS
        return out

    def ints(self, t) -> list:
        """The ints of (16, n) limbs."""
        cols = t.reshape(LIMBS, -1).cpu().numpy().astype(object)
        return [int(sum(int(cols[k, j]) << (BITS * k) for k in range(LIMBS)))
                for j in range(cols.shape[1])]

    def dot_small(self, t, k) -> int:
        """sum_j t_j k_j mod p for (16, n) plain limbs t and int64 k_j in
        [0, 2^15), n at most 2^20 (a column sum stays below 2^51)."""
        torch = self.torch
        k = torch.as_tensor(k, dtype=torch.int64, device=t.device)
        sums = (t * k[None]).sum(dim=1).tolist()
        return sum(int(s) << (BITS * i) for i, s in enumerate(sums)) % self.p

    # -------------------------------------------------------- arithmetic

    def _carry(self, t):
        """Propagate carries (or borrows) up to the top limb, in place."""
        for k in range(LIMBS - 1):
            t[k + 1] += t[k] >> BITS
            t[k] &= MASK
        return t

    def _minus_p_if_over(self, t):
        """t - p where t >= p, else t, for t in [0, 2p) with carried limbs."""
        d = self._carry(t - self.P.reshape((LIMBS,) + (1,) * (t.dim() - 1)))
        return self.torch.where(d[LIMBS - 1:] < 0, t, d)

    def add(self, a, b):
        return self._minus_p_if_over(self._carry(a + b))

    def sub(self, a, b):
        d = self._carry(a - b)
        neg = (d[LIMBS - 1:] < 0).to(d.dtype)
        return self._carry(d + neg * self.P.reshape((LIMBS,) + (1,) * (d.dim() - 1)))

    def mul(self, a, b):
        """a b R^-1 mod p (Montgomery's product), broadcasting over the
        dimensions after the first."""
        torch = self.torch
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape[1:]
        a, b = a.reshape(LIMBS, -1), b.reshape(LIMBS, -1)
        c = torch.zeros((2 * LIMBS, a.shape[1]), dtype=torch.int64, device=a.device)
        for i in range(LIMBS):
            c[i:i + LIMBS] += a[i] * b
        for i in range(LIMBS):
            m = ((c[i] & MASK) * self.pinv) & MASK
            c[i:i + LIMBS] += m * self.P
            c[i + 1] += c[i] >> BITS
        t = self._carry(c[LIMBS:].clone())
        return self._minus_p_if_over(t).reshape((LIMBS,) + tuple(shape))

    def to_mont(self, a):
        return self.mul(a, self.R2)

    def from_mont(self, a):
        return self.mul(a, self.ONE)

    def const(self, v: int):
        """The Montgomery form of v, (16, 1)."""
        return self.limbs([v % self.p * self.R % self.p])

    def powers(self, g: int, n: int):
        """[1, g, ..., g^(n-1)] in Montgomery form, (16, n), by doubling."""
        t = self.const(1)
        while t.shape[1] < n:
            t = self.torch.cat([t, self.mul(t, self.const(pow(g, t.shape[1], self.p)))], dim=1)
        return t[:, :n]

    def ntt(self, x, table):
        """y_j = sum_i x_i w^(ij) for (16, n) Montgomery x, n a power of two,
        natural order in and out; `table` is powers(w, n // 2)."""
        torch = self.torch
        n = x.shape[1]
        a = x[:, torch.as_tensor(bit_reverse(n), device=x.device)]
        m = 1
        while m < n:
            a = a.reshape(LIMBS, n // (2 * m), 2 * m)
            t = self.mul(a[:, :, m:], table[:, :: n // (2 * m)][:, None, :])
            u = a[:, :, :m]
            a = torch.cat([self.add(u, t), self.sub(u, t)], dim=2)
            m *= 2
        return a.reshape(LIMBS, n)
