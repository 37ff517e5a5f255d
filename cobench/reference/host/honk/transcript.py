# Frozen copy of cocircom_tpu_torch/honk/transcript.py (commit e513b03), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""Poseidon2 Fiat-Shamir transcript (Barretenberg-compatible).

Parity: upstream co-noir/ultrahonk/src/transcript.rs
(Poseidon2Transcript: consume/send/receive :77-210, challenge squeeze
get_next_challenge_buffer :216-247) and honk_curve.rs field packing
(Fq -> two Fr "136-bit low / 118-bit high" chunks, :83-113).

The transcript field IS BN254-Fr (transcript.rs:12), so proof_data is a
flat list of Fr ints; points contribute 4 elements (x, y each split in 2),
scalars 1, u64s 1. Challenges chain: each squeeze hashes
[previous_challenge] + round_data with the Poseidon2 sponge.
"""

from __future__ import annotations

from ..noir.poseidon2 import P as FR_P
from ..noir.poseidon2 import hash_fixed

NUM_LIMB_BITS = 68
LOWER_BITS = 2 * NUM_LIMB_BITS
LOWER_MASK = (1 << LOWER_BITS) - 1


def fq_to_frs(x: int) -> tuple[int, int]:
    """BN254 Fq value -> (low 136 bits, high 118 bits) as Fr elements."""
    return (x & LOWER_MASK, x >> LOWER_BITS)


def frs_to_fq(lo: int, hi: int) -> int:
    return lo + (hi << LOWER_BITS)


class Transcript:
    """Prover-side and verifier-side transcript (same chaining rules)."""

    def __init__(self, proof_data: list[int] | None = None):
        self.proof_data: list[int] = list(proof_data) if proof_data else []
        self.num_read = 0
        self.is_first_challenge = True
        self.round_data: list[int] = []
        self.previous_challenge = 0

    # ------------------------------------------------------------ sending

    def _consume(self, elements):
        self.round_data.extend(e % FR_P for e in elements)

    def _send(self, elements):
        els = [e % FR_P for e in elements]
        self.proof_data.extend(els)
        self._consume(els)

    def send_fr(self, label: str, x: int):
        self._send([x])

    def send_u64(self, label: str, x: int):
        self._send([x])

    def send_point(self, label: str, xy: tuple[int, int] | None):
        """xy = affine coords as Fq ints; None = point at infinity
        (sent as (0, 0), transcript.rs:86-96)."""
        x, y = (0, 0) if xy is None else xy
        x0, x1 = fq_to_frs(x)
        y0, y1 = fq_to_frs(y)
        self._send([x0, x1, y0, y1])

    def send_fr_vec(self, label: str, xs):
        self._send(list(xs))

    # ---------------------------------------------------------- receiving

    def _receive(self, n: int) -> list[int]:
        if self.num_read + n > len(self.proof_data):
            raise ValueError("proof too small")
        els = self.proof_data[self.num_read : self.num_read + n]
        self.num_read += n
        self._consume(els)
        return els

    def receive_fr(self, label: str) -> int:
        return self._receive(1)[0]

    def receive_u64(self, label: str) -> int:
        return self._receive(1)[0] & 0xFFFFFFFFFFFFFFFF

    def receive_point(self, label: str) -> tuple[int, int] | None:
        x0, x1, y0, y1 = self._receive(4)
        x, y = frs_to_fq(x0, x1), frs_to_fq(y0, y1)
        if x == 0 and y == 0:
            return None
        return (x, y)

    def receive_fr_vec(self, label: str, n: int) -> list[int]:
        return self._receive(n)

    # --------------------------------------------------------- challenges

    def _squeeze(self) -> int:
        if self.is_first_challenge:
            assert self.round_data, "challenge before any prover data"
            buf = self.round_data
            self.is_first_challenge = False
        else:
            buf = [self.previous_challenge] + self.round_data
        self.round_data = []
        ch = hash_fixed(buf, 1)
        self.previous_challenge = ch
        return ch

    def get_challenge(self, label: str) -> int:
        return self._squeeze()

    def get_challenges(self, labels) -> list[int]:
        return [self._squeeze() for _ in labels]
