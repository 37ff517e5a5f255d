"""The yardstick of the kernels' roofline shares: the card's peaks and the
work a launch needs, counted from its shapes and from what its inputs need,
never from which kernel ran or how it is written.

Peaks of one NVIDIA H100 SXM (the data sheet's numbers, which assume the
full 700 W power limit; a card set lower reaches less, so every reading
carries the card's limit beside it):

- memory: 3.35e12 bytes a second of HBM3;
- integer: NVIDIA publishes no INT32 rate.  It is derived as 132 SMs x 64
  INT32 lanes an SM (an IMAD a lane a clock) x 1.98e9 clocks a second (the
  boost clock) = 16.727e12 32-bit multiply-adds a second.

A launch's least time is the larger of its bytes over the memory peak and
its multiply-adds over the integer peak.  The count functions are copies of
`chip_smoke.py`'s `bound` and `ntt_products` and of the per-kernel counts
of its `kernels` phase (commit c520732).
"""

from __future__ import annotations

MEM_RATE = 3.35e12
SMS, INT32_LANES, BOOST_HZ = 132, 64, 1.98e9
INT_MAD_RATE = SMS * INT32_LANES * BOOST_HZ


def bound_s(nbytes: float, mads: float) -> float:
    """The least seconds a launch of this work takes on the card."""
    return max(nbytes / MEM_RATE, mads / INT_MAD_RATE)


def mont_products(L: int) -> int:
    """Multiply-adds of one L-limb Montgomery product (CIOS: L^2 for the
    product, L^2 + L for the reduction)."""
    return 2 * L * L + L


def mont_squares(L: int) -> int:
    """Multiply-adds of one Montgomery squaring."""
    return L * (L + 1) // 2 + L * L + L


def ntt_products(logm: int) -> int:
    """Products a 2^logm-point transform needs: its radix-2 network less
    the 2^logm - 1 butterflies by w^0 = 1."""
    return logm * (1 << (logm - 1)) - ((1 << logm) - 1)


# ------------------------------------------------------------ per kernel

def mont_mul_work(L: int, n: int, a_single: bool, b_single: bool) -> tuple:
    """(bytes, multiply-adds) of n elementwise products; an operand passed
    as one element is read once."""
    W = 4 * L
    reads = (1 if a_single else n) + (1 if b_single else n)
    return W * (reads + n), mont_products(L) * n


def ntt_columns_work(L: int, M: int, cols: int, V: int, post: bool) -> tuple:
    """(bytes, multiply-adds) of one four-step pass: the M-point transform
    of `cols` columns (x read, the output written, the twiddles read once),
    and with a factor table (L, M, V) its read and one product an output."""
    W = 4 * L
    logm = M.bit_length() - 1
    nbytes = 2 * W * M * cols + W * (M // 2)
    mads = ntt_products(logm) * cols * mont_products(L)
    if post:
        nbytes += W * M * V
        mads += M * cols * mont_products(L)
    return nbytes, mads


def ec_madd_work(L: int, nw: int, kp1: int, valid: int) -> tuple:
    """(bytes, multiply-adds) of one mixed-add wave: the (nw, K+1) run
    bounds (two int64 tables) read, and for each lane that adds a point its
    affine row (2 elements) read and its Jacobian accumulator (3 elements)
    read and written; 7 products and 4 squarings a mixed add."""
    W = 4 * L
    nbytes = 16 * nw * kp1 + (2 * W + 6 * W) * valid
    return nbytes, (7 * mont_products(L) + 4 * mont_squares(L)) * valid


def share_pct(bound_seconds: float, device_seconds: float) -> float | None:
    """The roofline share in percent, or None where the kernel never ran."""
    if device_seconds <= 0 or bound_seconds <= 0:
        return None
    return 100.0 * bound_seconds / device_seconds
