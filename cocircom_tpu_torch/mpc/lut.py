"""Secret-shared lookup tables (REP3) — the memory backend for co-noir.

Parity: upstream mpc-core/src/protocols/rep3/lut.rs (LookupTableProvider:
init_set/contains_set :16-38, init_map :40-46, get_from_lut :48-76,
write_to_lut :78-95, or_tree :98-142).

Batched redesign: the reference scans the table with ONE equality + cmux
per entry (each a full a2b round trip — O(table) communication rounds).
Here the needle is broadcast against the whole key vector and every step
is batched: one a2b + AND tree for ALL equality bits, one bit-inject, one
mul_vec for the select — a CONSTANT number of rounds (~log bitlen + 3)
whatever the table size, with all the work on (L, N) int32 limb tensors on
the driver's device.  The same calls in the same order as the JAX
package's lut.py, so the share components are the same for the same PRF
seeds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .rep3 import Rep3Driver, Rep3FieldShare
from .rep3_binary import Rep3BinaryShare


class SharedMap(NamedTuple):
    """Batched key/value share vectors ((L, N) components)."""

    keys: Rep3FieldShare | torch.Tensor  # shares, or a public (L, N) tensor
    values: Rep3FieldShare
    public_keys: bool


class Rep3Lut:
    def __init__(self, driver: Rep3Driver):
        self.d = driver
        self.bin = driver.binary

    # ------------------------------------------------------------- sets

    def init_set(self, values: Rep3FieldShare) -> Rep3FieldShare:
        return values

    def contains_set(self, needle: Rep3FieldShare, s: Rep3FieldShare):
        """[1 if needle in set else 0] arithmetic share (lut.rs:24-38).
        OR tree computed as NOT(AND_i NOT(eq_i)) on the batched bits."""
        bits = self._eq_bits_binary(needle, s, public_keys=False)
        bn = self.bin
        nots = bn.xor_public(bits, bn._bc(1, bits.a.shape[1:]))  # complement each bit
        acc = nots
        n = acc.a.shape[-1]
        while n > 1:
            half = n // 2
            lo = Rep3BinaryShare(acc.a[..., :half], acc.b[..., :half])
            hi = Rep3BinaryShare(acc.a[..., half: 2 * half], acc.b[..., half: 2 * half])
            red = bn.and_(lo, hi)
            if n % 2:
                red = Rep3BinaryShare(torch.cat([red.a, acc.a[..., -1:]], -1),
                                      torch.cat([red.b, acc.b[..., -1:]], -1))
            acc = red
            n = acc.a.shape[-1]
        onec1 = bn._bc(1, acc.a.shape[1:])
        result_bit = bn.xor_public(acc, onec1)
        # scrub the AND-round mask bits above bit 0 from the components
        # (value-neutral; bit_inject lifts raw component values)
        result_bit = bn.and_public(result_bit, onec1)
        return self.d.index_share(bn.bit_inject(result_bit), 0)

    # ------------------------------------------------------------- maps

    def init_map_public_keys(self, values: Rep3FieldShare) -> SharedMap:
        """Map with keys = 0..N-1 in clear (the ACVM memory-block case —
        co-acvm memory_solver.rs indexes by position)."""
        f = self.d.fr
        n = values.a.shape[-1]
        return SharedMap(f.encode(np.arange(n)), values, True)

    def init_map(self, keys: Rep3FieldShare, values: Rep3FieldShare) -> SharedMap:
        return SharedMap(keys, values, False)

    def _eq_bits_binary(self, needle, keys, public_keys: bool):
        """1-bit binary shares of (needle == key_i) for the whole vector."""
        d = self.d
        n = (keys.shape if public_keys else keys.a.shape)[-1]
        nb = d.broadcast_share(needle, n)
        if public_keys:
            # share - public via the party-dependent convention
            # (rep3.rs add_with_public; only one additive component shifts)
            diff = d.add_public(nb, d.fr.neg(keys))
        else:
            diff = d.sub(nb, keys)
        return self.bin.is_zero(self.bin.a2b(diff))

    def eq_bits(self, needle, keys, public_keys: bool) -> Rep3FieldShare:
        """Arithmetic 0/1 share vector of needle == key_i."""
        return self.bin.bit_inject(self._eq_bits_binary(needle, keys, public_keys))

    def read(self, needle: Rep3FieldShare, m: SharedMap) -> Rep3FieldShare:
        """sum_i [needle == key_i] * value_i — 0 if the needle is absent
        (the reference blinds misses with zero-shares; the arithmetic sum
        form needs no blinding: the eq bits are themselves shares)."""
        b = self.eq_bits(needle, m.keys, m.public_keys)
        return self.d.sum_vec(self.d.mul_vec(b, m.values))

    def write(self, needle: Rep3FieldShare, value: Rep3FieldShare,
              m: SharedMap) -> SharedMap:
        """value_i' = value_i + [needle == key_i] * (value - value_i)."""
        d = self.d
        b = self.eq_bits(needle, m.keys, m.public_keys)
        n = m.values.a.shape[-1]
        delta = d.sub(d.broadcast_share(value, n), m.values)
        new_vals = d.add(m.values, d.mul_vec(b, delta))
        return SharedMap(m.keys, new_vals, m.public_keys)
