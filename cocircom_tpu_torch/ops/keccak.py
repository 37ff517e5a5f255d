"""Keccak-256 (original padding 0x01, NOT sha3) — host-side, from scratch.

Used by the PLONK Fiat-Shamir transcript, which must be byte-identical to
snarkjs (parity: co-plonk/src/types.rs:125-171 Keccak256Transcript).  A
pure-Python sponge: a transcript hashes a few hundred bytes.
"""

from __future__ import annotations

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(state: list[int]) -> None:
    for rnd in range(24):
        # theta
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(state[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y])
        # iota
        state[0] ^= _RC[rnd]


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for 256-bit output
    state = [0] * 25
    # pad10*1 with domain byte 0x01 (keccak, not sha3's 0x06)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        _keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


class Keccak256Transcript:
    """snarkjs-compatible transcript: big-endian scalars/points, infinity as
    2*n8q zero bytes, challenge = digest interpreted BE mod r."""

    def __init__(self, curve):
        self.curve = curve
        self._buf = bytearray()

    def add_scalar(self, v: int):
        self._buf += int(v % self.curve.fr.p).to_bytes(self.curve.fr.n8, "big")

    def add_point(self, pt):
        n8q = self.curve.fq.n8
        if pt is None:
            self._buf += b"\x00" * (2 * n8q)
        else:
            self._buf += int(pt[0]).to_bytes(n8q, "big")
            self._buf += int(pt[1]).to_bytes(n8q, "big")

    def get_challenge(self) -> int:
        return int.from_bytes(keccak256(bytes(self._buf)), "big") % self.curve.fr.p
