"""Seeds derived from the run's `--seed`, one a purpose, so that the same
seed gives the same inputs and no two purposes share a stream."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from `seed` and the tags (any whole number, any size)."""
    text = ":".join(str(x) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
