"""Prime-field arithmetic on torch tensors: Montgomery form, 32-bit limbs.

Representation (decided once, here):
  * A field element is ``L`` limbs of 32 bits, least significant first,
    stored as bit patterns in ``torch.int32`` (``torch.uint32`` has almost
    no operators on the CPU).  BN254 Fr and Fq and BLS12-381 Fr have L = 8,
    BLS12-381 Fq has L = 12.
  * Tensors are **limb-axis-first**, shape ``(L, *batch)``: thread j of a
    kernel reads limb i of element j at ``i * n + j``, so neighbouring
    threads read neighbouring addresses.
  * Montgomery domain with R = 2^(32 L) (2^256, and 2^384 for BLS12-381 Fq),
    the R that the circom/snarkjs file formats use, so zkey and wtns bytes load by
    reinterpretation.  It is also the R of the JAX package, whose elements
    are 2L limbs of 16 bits held in uint32: ``pack16_to_32`` and
    ``unpack32_to_16`` convert by pairing limbs, with no arithmetic.
  * Whenever limbs are shifted, added or compared in torch code they are
    first widened to int64 and masked to 32 bits.

``mont_mul`` launches the hand-written CUDA kernel (csrc/mont_mul.cu) for a
CUDA tensor and takes ``mont_mul_plain`` only for a CPU tensor.  The plain
version works on 16-bit limbs in int64 the way the JAX package does:
schoolbook product into deferred columns (< 2^37), full-width REDC, one
conditional subtraction.  add / sub / neg / select are plain torch ops on
either device.

Ground truth: cocircom_tpu_torch.fields.params.HostField (python ints).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields.params import HostField
from . import kernels
from .kernels import broadcast_shapes

W = 32
M32 = 0xFFFFFFFF
_I63 = 1 << 63
M16 = 0xFFFF


# ---------------------------------------------------------------- devices

def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cocircom_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ------------------------------------------------------------ limb repack

def u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def pack16_to_32(x16: torch.Tensor) -> torch.Tensor:
    """(2L, *batch) 16-bit limbs (any integer dtype) -> (L, *batch) int32."""
    x = x16.to(torch.int64)
    return (x[0::2] | (x[1::2] << 16)).to(torch.int32)


def unpack32_to_16(x32: torch.Tensor) -> torch.Tensor:
    """(L, *batch) int32 -> (2L, *batch) 16-bit limbs in int64."""
    x = u64(x32)
    out = torch.stack([x & M16, x >> 16], dim=1)
    return out.reshape((2 * x32.shape[0],) + tuple(x32.shape[1:]))


# ------------------------------------------------- host (numpy) conversions

def ints_to_limbs_np(vals, L: int) -> np.ndarray:
    """python int(s) -> (L, *batch) uint32, 32-bit limbs (no reduction)."""
    arr = np.asarray(vals, dtype=object)
    flat = arr.reshape(-1)
    buf = b"".join(int(v).to_bytes(4 * L, "little") for v in flat)
    a = np.frombuffer(buf, dtype="<u4").reshape(flat.shape[0], L)
    return np.ascontiguousarray(a.T).reshape((L,) + arr.shape)


def limbs_np_to_ints(limbs: np.ndarray) -> np.ndarray:
    """(L, *batch) uint32 -> object ndarray of python ints."""
    L = limbs.shape[0]
    batch = limbs.shape[1:]
    rows = np.ascontiguousarray(limbs.reshape(L, -1).T).astype("<u4")
    raw = rows.tobytes()
    n = rows.shape[0]
    out = np.empty(n, dtype=object)
    for j in range(n):
        out[j] = int.from_bytes(raw[4 * L * j: 4 * L * (j + 1)], "little")
    return out.reshape(batch) if batch else out[0]


def bytes_to_limbs_np(data: bytes, n: int, L: int) -> np.ndarray:
    """n little-endian 4L-byte elements -> (L, n) uint32 (taken as they are)."""
    a = np.frombuffer(data, dtype="<u4", count=n * L)
    return np.ascontiguousarray(a.reshape(n, L).T)


def limbs_np_to_bytes(limbs: np.ndarray) -> bytes:
    L = limbs.shape[0]
    return np.ascontiguousarray(limbs.reshape(L, -1).T).astype("<u4").tobytes()


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ------------------------------------------------------------ carry chains

@functools.lru_cache(maxsize=None)
def _limb_index(k: int, ndim: int, device) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int64, device=device).reshape(
        (k,) + (1,) * (ndim - 1))


def _normalize(x: torch.Tensor, w: int, bound_bits: int) -> torch.Tensor:
    """Non-negative int64 columns (limb axis 0, each below 2^bound_bits) ->
    canonical w-bit limbs of the same value mod 2^(w k), in a fixed number
    of whole-tensor ops instead of a k-step ripple.

    A few parallel passes (keep the low w bits, hand the rest to the next
    column) bring every column into [0, 2^w].  What is left is a ripple of
    single-bit carries: column i generates one if it equals 2^w and passes
    one on if it equals 2^w - 1.  Packing those flags into two integers G
    and P, the carries into every column are the bits of (2G + P) ^ P, the
    carry vector of the binary addition (G | P) + G.  A column below
    2^(w+1) - 1 generates at most one carry and, when it generates one,
    does not propagate, so the passes stop there."""
    k = x.shape[0]
    mask = (1 << w) - 1
    top = (1 << bound_bits) - 1
    while top > (2 << w) - 2:
        hi = x >> w
        x = x & mask
        x[1:] += hi[:-1]
        top = mask + (top >> w)
    idx = _limb_index(k, x.dim(), x.device)
    gen = ((x >> w) << idx).sum(dim=0)
    prop = ((x == mask).to(torch.int64) << idx).sum(dim=0)
    cin = ((2 * gen + prop) ^ prop)[None]
    return (x + ((cin >> idx) & 1)) & mask


def _mul_cols16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of two k-limb 16-bit operands (int64, limb axis 0)
    into 2k deferred columns (each below 2^37 for k = 16): one outer product,
    then the anti-diagonal sums by the pad-and-reshape skew: the products
    are written into the first k of 2k + 1 columns of a row, the rest
    zero, so that row i read with stride 2k starts i columns late."""
    k = a.shape[0]
    batch = tuple(broadcast_shapes(a.shape[1:], b.shape[1:]))
    skew = torch.empty((k, 2 * k + 1) + batch, dtype=torch.int64, device=a.device)
    skew[:, k:] = 0
    torch.mul(a.unsqueeze(1), b.unsqueeze(0), out=skew[:, :k])
    skew = skew.reshape((k * (2 * k + 1),) + batch)
    return skew[: 2 * k * k].reshape((k, 2 * k) + batch).sum(dim=0)


def _toeplitz16(c: int, k: int, rows: int, device) -> torch.Tensor:
    """The (rows, k) float64 matrix T with (T @ x)[j] = sum_i c_{j-i} x_i,
    c_m the 16-bit limbs of the constant c: the product columns of c and a
    k-limb operand x as one matrix product."""
    limbs = [(c >> (16 * m)) & M16 for m in range(k)]
    t = [[float(limbs[j - i]) if 0 <= j - i < k else 0.0 for i in range(k)]
         for j in range(rows)]
    return torch.tensor(t, dtype=torch.float64, device=device)


def _mul_const_cols16(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Product columns of 16-bit limbs x (int64, limb axis 0, each below
    2^16) and a constant, through its _toeplitz16 matrix t: a float64
    matrix product, exact because a column sums at most 24 products below
    2^32, far below 2^53."""
    flat = x.reshape(x.shape[0], -1).to(torch.float64)
    return (t @ flat).to(torch.int64).reshape((t.shape[0],) + tuple(x.shape[1:]))


def mont_mul_plain(f: "Field", a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p on (L, *batch) int32 limbs, either device, in plain
    torch ops: the same function as the CUDA kernel `mont_mul`.  One operand
    may be any value below R as long as the product is below R*p."""
    a16 = unpack32_to_16(a)
    b16 = unpack32_to_16(b)
    return f._redc16(_mul_cols16(a16, b16))


class Field:
    """Limb arithmetic for one prime field on one device.  Create through
    :func:`get_field`, which caches one instance per (p, name, device)."""

    def __init__(self, p: int, name: str = "F", device=None):
        self.p = p
        self.name = name
        self.device = resolve_device(device)
        self.host = HostField(p, name)
        self.bits = p.bit_length()
        self.L = -(-self.bits // W)
        self.L16 = 2 * self.L
        L = self.L
        self.R = 1 << (W * L)
        if not (2 * p < self.R):
            raise ValueError("need 2p < R for single conditional subtraction")
        self.n0inv = (-pow(p, -1, 1 << W)) % (1 << W)
        self.nprime = (-pow(p, -1, self.R)) % self.R
        self.r_mod_p = self.R % p
        self.r2 = (self.R * self.R) % p
        self.p_np = ints_to_limbs_np(p, L)
        dev = self.device
        i64 = dict(dtype=torch.int64, device=dev)
        self._p32 = torch.tensor([(p >> (W * i)) & M32 for i in range(L)], **i64)
        # ~p + 1 limb by limb: adding it subtracts p in two's complement
        self._negp32 = (self._p32 ^ M32) + torch.tensor([1] + [0] * (L - 1), **i64)
        self._one_col = torch.tensor([1] + [0] * (L - 1), **i64)
        # REDC's products by the constants -p^-1 (its low 2L columns) and p
        self._np_t = _toeplitz16(self.nprime, 2 * L, 2 * L, dev)
        self._p_t = _toeplitz16(p, 2 * L, 4 * L, dev)
        self._one_mont = self._const(self.r_mod_p)
        self._one_std = self._const(1)
        self._r2 = self._const(self.r2)

    # ------------------------------------------------------------------
    # host conversions
    # ------------------------------------------------------------------

    def _const(self, v: int) -> torch.Tensor:
        """python int -> (L,) int32 limbs on the device (no Montgomery)."""
        return self.from_numpy(ints_to_limbs_np(v, self.L))

    def from_numpy(self, limbs: np.ndarray) -> torch.Tensor:
        """(L, *batch) uint32 numpy -> int32 tensor on this field's device."""
        a = np.ascontiguousarray(limbs, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(a.copy()).to(self.device)

    def kernel_consts(self, b3_mont: int = 0, b3_mont_im: int = 0):
        """The constant block the CUDA kernels take by value: p, -p^-1 mod
        2^32, and (for curve kernels) 3b in Montgomery form, real and
        imaginary part."""
        words = [(self.p >> (W * i)) & M32 for i in range(self.L)]
        words.append(self.n0inv)
        words += [(b3_mont >> (W * i)) & M32 for i in range(self.L)]
        words += [(b3_mont_im >> (W * i)) & M32 for i in range(self.L)]
        return (ctypes.c_uint32 * len(words))(*words)

    @functools.cached_property
    def kconsts(self):
        return self.kernel_consts()

    def to_limbs(self, vals) -> torch.Tensor:
        """python int(s) -> (L, *batch) int32 limbs (standard form).  Values
        in [0, 2^63) (selectors, indices: most of a proving key) go through
        numpy int64, the others one int at a time: on a million values
        about 20x faster than all one at a time."""
        arr = np.asarray(vals, dtype=object)
        flat = arr.reshape(-1)
        small = np.fromiter((v if 0 <= v < _I63 else -1 for v in flat), dtype=np.int64,
                            count=flat.shape[0])
        limbs = np.zeros((self.L, flat.shape[0]), dtype=np.uint32)
        limbs[0] = small & M32
        limbs[1] = small >> 32
        big = np.flatnonzero(small < 0)
        if big.size:
            red = np.array([int(flat[i]) % self.p for i in big], dtype=object)
            limbs[:, big] = ints_to_limbs_np(red, self.L)
        return self.from_numpy(limbs.reshape((self.L,) + arr.shape))

    def from_limbs(self, limbs) -> np.ndarray:
        """(L, *batch) limbs -> object ndarray of python ints (host)."""
        if isinstance(limbs, torch.Tensor):
            limbs = to_numpy_u32(limbs)
        return limbs_np_to_ints(np.asarray(limbs, dtype=np.uint32))

    def bytes_to_limbs(self, data: bytes, n: int) -> torch.Tensor:
        """n little-endian 4L-byte elements -> (L, n) limbs, taken as is."""
        return self.from_numpy(bytes_to_limbs_np(data, n, self.L))

    def limbs_to_bytes(self, limbs) -> bytes:
        if isinstance(limbs, torch.Tensor):
            limbs = to_numpy_u32(limbs)
        return limbs_np_to_bytes(limbs)

    # ------------------------------------------------------------------
    # Montgomery conversions
    # ------------------------------------------------------------------

    def to_mont(self, a):
        return self.mont_mul(a, self._bc(self._r2, a))

    def from_mont(self, a):
        return self.mont_mul(a, self._bc(self._one_std, a))

    def encode(self, vals):
        """host ints -> Montgomery limbs on the device."""
        return self.to_mont(self.to_limbs(vals))

    def decode(self, limbs) -> np.ndarray:
        """Montgomery limbs -> host python ints."""
        return self.from_limbs(self.from_mont(limbs))

    # ------------------------------------------------------------------
    # constants / shaping
    # ------------------------------------------------------------------

    def _bc(self, const: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """(L,) constant shaped to broadcast against `like`."""
        return const.reshape((self.L,) + (1,) * (like.dim() - 1))

    def const_mont(self, v: int) -> torch.Tensor:
        """host int -> (L,) Montgomery constant."""
        return self._const((v * self.R) % self.p)

    def zeros(self, batch_shape=()):
        return torch.zeros((self.L,) + tuple(batch_shape), dtype=torch.int32,
                           device=self.device)

    def one_mont(self, batch_shape=()):
        shape = (self.L,) + tuple(batch_shape)
        return self._one_mont.reshape((self.L,) + (1,) * len(batch_shape)).expand(shape)

    # ------------------------------------------------------------------
    # ring ops (inputs canonical < p, limb-first (L, *batch))
    # ------------------------------------------------------------------

    def _col(self, const: torch.Tensor, like_dim: int) -> torch.Tensor:
        return const.reshape((-1,) + (1,) * (like_dim - 1))

    def _two_chains(self, first, second):
        """Normalize two (L, *batch) column sets (each below 2^35) at once,
        each extended by one column that catches its carry-out.  Returns
        (limbs (2, L, *batch), carry-out (2, *batch))."""
        both = torch.empty((self.L + 1, 2) + tuple(first.shape[1:]), dtype=torch.int64,
                           device=first.device)
        both[: self.L, 0] = first
        both[: self.L, 1] = second
        both[self.L] = 0
        both = _normalize(both, W, 35).movedim(0, 1)
        return both[:, : self.L], both[:, self.L]

    def _cond_sub_p(self, x):
        """x < 2p as int32 limbs -> x mod p."""
        s = u64(x)
        limbs, carry = self._two_chains(s, s + self._col(self._negp32, s.dim()))
        return torch.where((carry[1] != 0)[None], limbs[1], limbs[0]).to(torch.int32)

    # columns of one piece of `add` / `sub` (see _by_pieces)
    PIECE = 1 << 22

    def _by_pieces(self, fn, a, b, out=None):
        """fn(a, b) for two (L, n) operands (one may be a size-1 batch), in
        column pieces of at most PIECE elements when n is larger: the plain
        carry chains hold a few int64 copies of their operands, which at
        2^27 elements would be tens of GiB.  The result is the same.  With
        `out` (which may be `a` or `b`) it is written there."""
        if a.dim() != 2 or b.dim() != 2 or max(a.shape[1], b.shape[1]) <= self.PIECE:
            res = fn(a, b)
            return res if out is None else out.copy_(res)
        n = max(a.shape[1], b.shape[1])
        shape = (self.L, n)
        a, b = a.expand(shape), b.expand(shape)
        if out is None:
            out = torch.empty(shape, dtype=torch.int32, device=a.device)
        for lo in range(0, n, self.PIECE):
            hi = min(n, lo + self.PIECE)
            out[:, lo:hi] = fn(a[:, lo:hi], b[:, lo:hi])
        return out

    def add(self, a, b, out=None):
        return self._by_pieces(self._add, a, b, out)

    def sub(self, a, b, out=None):
        return self._by_pieces(self._sub, a, b, out)

    def _add(self, a, b):
        """(a + b) mod p.  The second chain is a + b - p in two's complement
        (a + b + ~p + 1): its carry-out says a + b >= p."""
        s = u64(a) + u64(b)
        limbs, carry = self._two_chains(s, s + self._col(self._negp32, s.dim()))
        return torch.where((carry[1] != 0)[None], limbs[1], limbs[0]).to(torch.int32)

    def _sub(self, a, b):
        """(a - b) mod p.  First chain a + ~b + 1 (carry-out says a >= b),
        second the same plus p, taken when the first borrowed."""
        d = u64(a) + (u64(b) ^ M32) + self._col(self._one_col, a.dim())
        limbs, carry = self._two_chains(d, d + self._col(self._p32, d.dim()))
        return torch.where((carry[0] != 0)[None], limbs[0], limbs[1]).to(torch.int32)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def _redc16(self, acc):
        """Wide deferred 16-bit columns (int64, limb axis 0, value < R*p) ->
        canonical Montgomery residue as int32 limbs, by full-width REDC:
            q = (T mod R)(-p^-1) mod R ;  res = (T + q p) / R < 2p."""
        L16 = self.L16
        tc = _normalize(acc, 16, 37)
        q = _normalize(_mul_const_cols16(tc[:L16], self._np_t), 16, 37)
        s = _normalize(tc + _mul_const_cols16(q, self._p_t), 16, 38)
        return self._cond_sub_p(pack16_to_32(s[L16:]))

    def mont_mul(self, a, b):
        if a.is_cuda or b.is_cuda:
            return kernels.mont_mul(a, b, self.kconsts)
        return mont_mul_plain(self, a, b)

    def mont_sqr(self, a):
        return self.mont_mul(a, a)

    def reduce_cols(self, cols: torch.Tensor) -> torch.Tensor:
        """Per-limb integer sums of Montgomery elements ((L, *batch) int64,
        each column below 2^62) -> the sum mod p as a canonical element.
        The total V = lo + hi R is folded as lo*1 + hi*R, both through
        `mont_mul`."""
        ext = torch.cat([cols, torch.zeros_like(cols[:2])], dim=0)
        limbs = _normalize(ext, W, 62)
        lo = limbs[: self.L].to(torch.int32)
        hi = torch.cat(
            [limbs[self.L: self.L + 2],
             torch.zeros_like(limbs[: self.L - 2])], dim=0).to(torch.int32)
        lo = self.mont_mul(lo, self._bc(self._one_mont, lo))
        hi = self.mont_mul(hi, self._bc(self._r2, hi))
        return self.add(lo, hi)

    def mont_reduce_wide(self, lo, hi):
        """REDC of the 2L-limb value lo + hi R (lo < R, hi < p, the whole
        below R p): (lo R^-1 + hi) mod p."""
        return self.add(self.mont_mul(lo, self._bc(self._one_std, lo)), hi)

    # ------------------------------------------------------------------
    # predicates / selection
    # ------------------------------------------------------------------

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def select(self, mask, a, b):
        """mask: bool (*batch); a where mask else b."""
        return torch.where(mask[None], a, b)

    # ------------------------------------------------------------------
    # exponentiation / inversion (Montgomery domain)
    # ------------------------------------------------------------------

    def pow_static(self, a, e: int):
        """a^e for a host-static exponent (left-to-right binary)."""
        if e == 0:
            return self.one_mont(a.shape[1:]).contiguous()
        acc = a
        for c in bin(e)[3:]:
            acc = self.mont_mul(acc, acc)
            if c == "1":
                acc = self.mont_mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inverse; 0 -> 0.  On the card a chain of about 1.5 bitlen
        `mont_mul` launches; on the CPU the same residues by Python's pow
        (the plain chain costs about 0.4 s a call there)."""
        if a.is_cuda:
            return self.pow_static(a, self.p - 2)
        vals = np.asarray(self.decode(a), dtype=object).reshape(-1)
        inv = [pow(int(v), self.p - 2, self.p) for v in vals]
        return self.encode(np.asarray(inv, dtype=object).reshape(a.shape[1:]))

    def batch_inv(self, a, axis: int = 1):
        """Montgomery's trick along one batch axis as a product tree:
        pairwise products up, one inversion at the root, inverses pushed
        back down (about 3n multiplies).  Zero entries map to zero."""
        a = a.movedim(axis, -1)
        zmask = self.is_zero(a)
        one = self._one_mont.reshape((self.L,) + (1,) * (a.dim() - 1))
        safe = torch.where(zmask[None], one, a)
        n = safe.shape[-1]
        size = 1 << max(n - 1, 0).bit_length()
        if size != n:
            pad = one.expand(safe.shape[:-1] + (size - n,))
            safe = torch.cat([safe, pad], dim=-1)
        levels = [safe.contiguous()]
        while levels[-1].shape[-1] > 1:
            cur = levels[-1]
            levels.append(self.mont_mul(cur[..., 0::2].contiguous(),
                                        cur[..., 1::2].contiguous()))
        inv = self.inv(levels[-1])
        for cur in reversed(levels[:-1]):
            left = self.mont_mul(inv, cur[..., 1::2].contiguous())
            right = self.mont_mul(inv, cur[..., 0::2].contiguous())
            inv = torch.stack([left, right], dim=-1).reshape(cur.shape)
        out = inv[..., :n]
        out = torch.where(zmask[None], torch.zeros_like(out), out)
        return out.movedim(-1, axis).contiguous()

    # ------------------------------------------------------------------
    # reductions
    # ------------------------------------------------------------------

    def sum(self, a, axis: int = 1):
        """Modular sum over one batch axis (inputs canonical Montgomery):
        integer column sums in int64 (up to 2^30 terms), then one fold."""
        if axis < 1:
            raise ValueError("axis 0 is the limb axis")
        return self.reduce_cols(u64(a).sum(dim=axis))

    def prefix_sums(self, a, axis: int = 1):
        """Inclusive prefix sums along one batch axis (canonical Montgomery
        in and out): integer column prefix sums in int64 (up to 2^30
        terms), then one fold."""
        if axis < 1:
            raise ValueError("axis 0 is the limb axis")
        return self.reduce_cols(torch.cumsum(u64(a), dim=axis))

    def cumprod(self, a, axis: int = 1):
        """Inclusive prefix products along one batch axis (public values,
        Montgomery domain), log-depth: step s multiplies every element from
        position 2^s on by the one 2^s before it (Hillis-Steele), one
        `mont_mul` a step."""
        if axis < 1:
            raise ValueError("axis 0 is the limb axis")
        n = a.shape[axis]
        x = a
        for s in range(max(n - 1, 0).bit_length()):
            shift = 1 << s
            tail = self.mont_mul(x.narrow(axis, shift, n - shift), x.narrow(axis, 0, n - shift))
            x = torch.cat([x.narrow(axis, 0, shift), tail], dim=axis)
        return x


@functools.lru_cache(maxsize=None)
def _get_field(p: int, name: str, device: torch.device) -> Field:
    return Field(p, name, device)


def get_field(p: int, name: str = "F", device=None) -> Field:
    """The field engine for (p, name) on `device` (default: the card)."""
    return _get_field(p, name, resolve_device(device))
