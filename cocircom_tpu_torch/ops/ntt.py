"""Radix-2 NTT over Fr with the snarkjs root-of-unity convention.

Data is (L, n) Montgomery limbs, natural order in and out, and every output
is a canonical residue, so the result is bit-exact whichever path runs:

  * below 2^FOURSTEP_MIN_LOG points: the whole transform is one launch of
    the CUDA kernel `ntt_butterfly` (`ntt_small_plain` for CPU tensors: a
    bit-reversal gather, then one butterfly per stage, then 1/n for an
    inverse transform);
  * from there on: Bailey's four-step recursion.  The array is viewed as
    (L, U, V*B) with U <= 2^KMAX; one launch of the CUDA kernel
    `ntt_columns` (`ntt_columns_plain` for CPU tensors) transforms every
    column, multiplies by w_M^(k1 v) (and by 1/n at the top of an inverse
    transform) and stores the result transposed, and the rows recurse: a
    2^20 transform is two launches.

Share-local (linear), so the MPC drivers call it on each share component.
Root convention: fields/params.py (snarkjs tower).  `NTTEngine.ntt`, `intt`
and `coset_shift` are the spans `ntt.forward`, `ntt.inverse` and
`ntt.coset` (utils/trace.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import HostField
from ..utils.trace import spanned
from . import kernels
from .field import Field, add_plain, mont_mul_plain, sub_plain


def butterfly_plain(f: Field, e, o, w):
    """(e + o w, e - o w) mod p in plain torch: the same function as the
    CUDA kernel `ntt_butterfly`."""
    t = mont_mul_plain(f, o, w)
    return add_plain(f, e, t), sub_plain(f, e, t)


@functools.lru_cache(maxsize=None)
def _bitrev(logn: int) -> np.ndarray:
    n = 1 << logn
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _bitrev_index(logn: int, device: torch.device) -> torch.Tensor:
    """_bitrev(logn) on `device`, made once (no host copy in a steady loop)."""
    return torch.from_numpy(_bitrev(logn)).to(device)


def ntt_small_plain(f: Field, a, tw, scale=None):
    """NTT of (L, n) limbs, natural order in and out, tw (L, n/2) =
    w^0..w^(n/2-1), every output times `scale` ((L, 1), the 1/n of an
    inverse transform) when given; plain torch, the same function as the
    CUDA kernel `ntt_butterfly`: a bit-reversal gather, then one radix-2
    butterfly a stage over the whole array."""
    L, n = a.shape
    logn = n.bit_length() - 1
    a = a.index_select(1, _bitrev_index(logn, a.device))
    for s in range(1, logn + 1):
        m = 1 << s
        half = m // 2
        v = a.reshape(L, n // m, m)
        even = v[:, :, :half].reshape(L, n // 2)
        odd = v[:, :, half:].reshape(L, n // 2)
        wj = tw[:, ::n // m][:, :half]
        wflat = wj[:, None, :].expand(L, n // m, half).reshape(L, n // 2)
        oe, oo = butterfly_plain(f, even, odd, wflat)
        a = torch.cat([oe.reshape(L, n // m, half), oo.reshape(L, n // m, half)],
                      dim=2).reshape(L, n)
    return a if scale is None else mont_mul_plain(f, a, scale)


def ntt_small(f: Field, a, tw, scale=None):
    if a.is_cuda:
        return kernels.ntt_butterfly(a.contiguous(), tw, f.kconsts, scale)
    return ntt_small_plain(f, a, tw, scale)


def ntt_columns_plain(f: Field, x, tw, post=None, transpose: bool = False):
    """NTT along axis 1 of x (L, U, V*B) for every column, natural order in
    and out, tw (L, U/2) = w^0..w^(U/2-1); then, when given, output (k1, v,
    b) times post[k1, v] (post (L, U, V); without it V = 1); then, with
    `transpose`, the result as (L, V, U*B), element (k1, v, b) at
    [v, k1*B + b].  Plain torch, the same function as the CUDA kernel
    `ntt_columns` (radix-2 decimation in time over bit-reversed input, then
    the product and the permute)."""
    L, M, cols = x.shape
    logm = M.bit_length() - 1
    a = x.index_select(1, _bitrev_index(logm, x.device))
    for s in range(1, logm + 1):
        m = 1 << s
        half = m // 2
        blk = a.reshape(L, M // m, m, cols)
        even = blk[:, :, :half]
        odd = blk[:, :, half:]
        wj = tw[:, :: M // m][:, None, :half, None]
        oe, oo = butterfly_plain(f, even, odd, wj)
        a = torch.cat([oe, oo], dim=2).reshape(L, M, cols)
    V = post.shape[2] if post is not None else 1
    a = a.reshape(L, M, V, cols // V)
    if post is not None:
        a = mont_mul_plain(f, a, post[:, :, :, None])
    if transpose:
        return a.permute(0, 2, 1, 3).reshape(L, V, M * (cols // V))
    return a.reshape(L, M, cols)


def ntt_columns(f: Field, x, tw, post=None, transpose: bool = False):
    if x.is_cuda:
        return kernels.ntt_columns(x.contiguous(), tw.contiguous(), f.kconsts, post, transpose)
    return ntt_columns_plain(f, x, tw, post, transpose)


class NTTEngine:
    # smallest log-size routed to the four-step path: one past the largest
    # transform `ntt_butterfly` takes
    FOURSTEP_MIN_LOG = kernels.NTT_SMALL_MAX_LOG + 1
    # largest transform one `ntt_columns` call holds on chip
    KMAX = kernels.NTT_COLUMNS_MAX_LOG

    def __init__(self, f: Field, host: HostField):
        assert f.p == host.p
        self.f = f
        self.host = host
        self._tw: dict = {}
        self._tbl: dict = {}
        self._ninv: dict = {}
        self._pow: dict = {}

    # -------------------------------------------------- twiddle tables

    def _root(self, logn: int, inverse: bool) -> int:
        w = self.host.root_of_unity(logn)
        return self.host.inv(w) if inverse else w

    def _twiddles(self, logn: int, inverse: bool):
        """(L, max(n/2,1)) powers w^0..w^(n/2-1), Montgomery, on device."""
        key = (logn, inverse)
        if key not in self._tw:
            n = 1 << logn
            t = power_table(self.f, self._root(logn, inverse), max(n // 2, 1))
            self._tw[key] = t.contiguous()
        return self._tw[key]

    def _n_inv(self, logn: int):
        if logn not in self._ninv:
            self._ninv[logn] = self.f.encode([self.host.inv(1 << logn)])
        return self._ninv[logn]

    # -------------------------------------------------- small transforms

    def _ntt(self, a, logn: int, inverse: bool):
        return ntt_small(self.f, a, self._twiddles(logn, inverse),
                         self._n_inv(logn) if inverse else None)

    # -------------------------------------------------- four-step path

    def _fourstep_table(self, logm: int, logu: int, inverse: bool, scale_log):
        """(L, U, V): w_M^(k1 v), times 1/2^scale_log at the top level of an
        inverse transform."""
        key = (logm, logu, inverse, scale_log)
        if key not in self._tbl:
            f = self.f
            U, V = 1 << logu, 1 << (logm - logu)
            pt = power_table(f, self._root(logm, inverse), 1 << logm)
            if scale_log is not None:
                pt = f.mont_mul(pt, self._n_inv(scale_log))
            k1 = np.arange(U, dtype=np.int64)[:, None]
            v = np.arange(V, dtype=np.int64)[None, :]
            idx = torch.from_numpy(((k1 * v) % (1 << logm)).reshape(-1)).to(pt.device)
            self._tbl[key] = pt.index_select(1, idx).reshape(f.L, U, V).contiguous()
        return self._tbl[key]

    def _fourstep(self, x, logm: int, inverse: bool, top_log=None):
        """NTT along axis 1 of x (L, M, B), natural order in and out.
        top_log: the whole transform's log-size at the top level (where an
        inverse transform folds in 1/n), else None."""
        f = self.f
        L, M, B = x.shape
        scale = top_log if inverse else None
        if logm <= self.KMAX:
            out = ntt_columns(f, x, self._twiddles(logm, inverse))
            if scale is not None:
                out = f.mont_mul(out, self._n_inv(scale)[:, :, None])
            return out
        logu = min(self.KMAX, logm - 1)
        logv = logm - logu
        U, V = 1 << logu, 1 << logv
        tbl = self._fourstep_table(logm, logu, inverse, scale)
        # the columns' transform, times w_M^(k1 v), stored as (L, V, U*B)
        y = ntt_columns(f, x.reshape(L, U, V * B), self._twiddles(logu, inverse), post=tbl,
                        transpose=True)
        z = self._fourstep(y, logv, inverse, None)
        # (L, V, U*B): the index along (axis 1, axis 2) is k2*U + k1 = natural
        return z.reshape(L, V * U, B)

    def _transform(self, a, inverse: bool):
        n = a.shape[1]
        logn = n.bit_length() - 1
        assert 1 << logn == n, "size must be a power of two"
        if n == 1:
            return a
        if logn >= self.FOURSTEP_MIN_LOG:
            return self._fourstep(a[:, :, None], logn, inverse, logn).reshape(
                self.f.L, n)
        return self._ntt(a, logn, inverse)

    @spanned("ntt.forward")
    def ntt(self, a):
        """Forward NTT of (L, n) Montgomery coeffs -> evals (natural order)."""
        return self._transform(a, False)

    @spanned("ntt.inverse")
    def intt(self, a):
        return self._transform(a, True)

    @spanned("ntt.coset")
    def coset_shift(self, a, g: int | None = None):
        """a[i] *= g^i; g defaults to the snarkjs Groth16 coset root."""
        n = a.shape[1]
        logn = n.bit_length() - 1
        if g is None:
            g = self.host.groth16_coset_root(logn)
        key = (g, n)
        if key not in self._pow:
            self._pow[key] = power_table(self.f, g, n).contiguous()
        return self.f.mont_mul(a, self._pow[key])


def power_table(f: Field, g: int, n: int):
    """[1, g, g^2, ..., g^(n-1)] as (L, n) Montgomery limbs, by doubling."""
    if n == 1:
        return f.encode([1])
    t = f.encode([1, g % f.p])
    gcur = g * g % f.p
    while t.shape[1] < n:
        t = torch.cat([t, f.mont_mul(t, f.encode([gcur]))], dim=1)
        gcur = gcur * gcur % f.p
    return t[:, :n]


@functools.lru_cache(maxsize=None)
def ntt_engine(f: Field, host: HostField) -> NTTEngine:
    return NTTEngine(f, host)
