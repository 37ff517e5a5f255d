"""Vectorized ChaCha12 as the MPC correlated PRF, in plain torch.

The upstream project keys every correlated randomness stream with 256-bit
ChaCha12 seeds from OS entropy (mpc-core/src/protocols/rep3/rngs.rs,
SEED_SIZE = 32 bytes).  The block function is pure 32-bit adds, xors and
rotations, vectorized over block counters, so mask tensors of any batch
shape are generated on the device that the stream lives on.  Words are held
in int64 and masked to 32 bits after every add and shift.  For a given seed
the stream equals the JAX package's word for word.

Layout: state rows held as four (4, n) arrays (A=consts, B/C=key,
D=counter/domain/nonce); a double round is one column QR + one diagonal QR
with row rolls.
"""

from __future__ import annotations

import hashlib
import secrets

import numpy as np
import torch

from ..ops.field import resolve_device

M32 = 0xFFFFFFFF
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x, n: int):
    return ((x << n) | (x >> (32 - n))) & M32


def _qr(a, b, c, d):
    a = (a + b) & M32
    d = _rotl(d ^ a, 16)
    c = (c + d) & M32
    b = _rotl(b ^ c, 12)
    a = (a + b) & M32
    d = _rotl(d ^ a, 8)
    c = (c + d) & M32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def chacha_blocks(key8, ctr0: int, domain: int, nblocks: int, rounds: int = 12):
    """key8: (8,) int64 key words on the target device; ctr0/domain: ints.
    Returns (16, nblocks) int64 words in [0, 2^32): one block per column."""
    ctr = torch.arange(nblocks, dtype=torch.int64, device=key8.device) + int(ctr0)
    return chacha_blocks_at(key8, ctr, domain, rounds)


def chacha_blocks_at(key8, ctr, domain: int, rounds: int = 12):
    """The blocks of the (n,) int64 block counters `ctr`: (16, n) int64
    words in [0, 2^32), one block per column."""
    ctr = ctr & M32
    n = ctr.shape[0]
    dev = key8.device
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    a0 = torch.tensor(_SIGMA, dtype=torch.int64, device=dev)[:, None].expand(4, n)
    b0 = key8[0:4, None].expand(4, n)
    c0 = key8[4:8, None].expand(4, n)
    d0 = torch.stack([ctr, torch.full_like(ctr, int(domain) & M32), zero, zero])
    a, b, c, d = a0, b0, c0, d0
    for _ in range(rounds // 2):
        a, b, c, d = _qr(a, b, c, d)  # column round (4 QRs batched)
        b = torch.roll(b, -1, dims=0)
        c = torch.roll(c, -2, dims=0)
        d = torch.roll(d, -3, dims=0)
        a, b, c, d = _qr(a, b, c, d)  # diagonal round
        b = torch.roll(b, 1, dims=0)
        c = torch.roll(c, 2, dims=0)
        d = torch.roll(d, 3, dims=0)
    return torch.cat([(a + a0) & M32, (b + b0) & M32, (c + c0) & M32, (d + d0) & M32], dim=0)


def seed_to_words(seed: bytes | int, device=None):
    """32-byte seed -> (8,) int64 key words on `device` (the card unless
    named).  Integer seeds (tests) are expanded through SHA-256 so no path
    ever keys ChaCha with < 256 bits."""
    if isinstance(seed, int):
        seed = hashlib.sha256(seed.to_bytes(32, "little", signed=False)).digest()
    if len(seed) != 32:
        raise ValueError("ChaCha seed must be exactly 32 bytes")
    words = np.frombuffer(seed, dtype="<u4").astype(np.int64)
    return torch.from_numpy(words).to(resolve_device(device))


def fresh_seed() -> bytes:
    return secrets.token_bytes(32)


class ChaChaStream:
    """A counter-mode ChaCha12 stream over one (key, domain) pair.

    Streams shared between two parties advance in lockstep as long as both
    sides make the same sequence of requests.  The stream lives on `device`:
    the card unless the caller names another."""

    def __init__(self, seed: bytes | int, domain: int = 0, device=None):
        self.key = seed_to_words(seed, device)
        self.domain = domain
        self.ctr = 0
        self._ahead = None   # (16, AHEAD) words of the blocks from _ahead_at on
        self._ahead_at = 0

    # words rand_mont makes at once; a larger draw is made in pieces of this
    # many words (the block function holds about 20 int64 copies of its
    # state), with the same words in the same places
    PIECE = 1 << 25
    # a draw of fewer blocks than this is cut from one call that makes this
    # many, and the blocks after it serve the next draws: the block function
    # is a few hundred tensor ops whatever its width, and the MPC rounds of
    # the binary domain draw a few hundred blocks each
    AHEAD = 1 << 13

    def words(self, shape):
        """uniform 32-bit words of `shape`, as int64 in [0, 2^32)."""
        total = 1
        for s in shape:
            total *= s
        nblk = max(1, -(-total // 16))
        if nblk >= self.AHEAD:
            out = chacha_blocks(self.key, self.ctr, self.domain, nblk)
        else:
            at = self.ctr - self._ahead_at
            if self._ahead is None or at < 0 or at + nblk > self.AHEAD:
                self._ahead = chacha_blocks(self.key, self.ctr, self.domain, self.AHEAD)
                self._ahead_at, at = self.ctr, 0
            out = self._ahead[:, at: at + nblk]
        self.ctr += nblk
        return out.t().reshape(-1)[:total].reshape(tuple(shape))

    def limbs16(self, shape):
        """uniform 16-bit limbs (int64): each word yields two limbs, low
        half first."""
        L = shape[0]
        rest = tuple(shape[1:])
        half = -(-L // 2)
        w = self.words((half,) + rest)
        both = torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape((2 * half,) + rest)
        return both[:L]

    def rand_mont(self, f, batch_shape=()):
        """uniform field element in Montgomery form (bias < 2^-240): 2L
        stream words w, top half-word zeroed, reduced as
        (w_lo + w_hi R) R^-1 mod p.  Word k of the stream is 32-bit limb k,
        i.e. the pair of 16-bit limbs (2k, 2k+1) of `limbs16`."""
        batch = tuple(batch_shape)
        n = 1
        for s in batch:
            n *= s
        if 2 * f.L * n <= self.PIECE:
            return self._reduce(f, self.words((2 * f.L,) + batch))
        out = torch.empty((f.L, n), dtype=torch.int32, device=self.key.device)
        for c0, c1, piece in self.rand_mont_pieces(f, n):
            out[:, c0:c1] = piece
        return out.reshape((f.L,) + batch)

    def rand_mont_pieces(self, f, n: int):
        """The draw rand_mont(f, (n,)) as (c0, c1, columns c0..c1) pieces of
        at most PIECE words, for callers that use it a piece at a time; the
        counter advances past the whole draw with the last piece.  Word k of
        limb row i is stream word i * n + k, so a piece reads a span of
        every row."""
        step = max(1, self.PIECE // (2 * f.L))
        dev = self.key.device
        for c0 in range(0, n, step):
            c1 = min(n, c0 + step)
            # the blocks that hold every row's span, made in one call
            starts = [i * n + c0 for i in range(2 * f.L)]
            spans = [(s // 16, -(-(s + c1 - c0) // 16)) for s in starts]
            ctr = torch.cat([torch.arange(b0, b1, dtype=torch.int64, device=dev)
                             for b0, b1 in spans]) + self.ctr
            w = chacha_blocks_at(self.key, ctr, self.domain).t().reshape(-1)
            del ctr
            rows, off = [], 0
            for s, (b0, b1) in zip(starts, spans):
                lo = off + s - 16 * b0
                rows.append(w[lo: lo + c1 - c0])
                off += 16 * (b1 - b0)
            rows = torch.stack(rows)
            del w
            piece = self._reduce(f, rows)
            if c1 == n:
                self.ctr += -(-2 * f.L * n // 16)
            yield c0, c1, piece

    @staticmethod
    def _reduce(f, w):
        lo = w[: f.L].to(torch.int32)
        hi = w[f.L:].clone()
        hi[f.L - 1] &= 0xFFFF
        return f.mont_reduce_wide(lo, hi.to(torch.int32))
