"""MPC-valued builder variables: shared ROM/RAM memory records for
co-UltraHonk.

The reference cannot prove memory circuits collaboratively (co-ultrahonk
memory handling is unreachable: the plain builder's ROM path todo!()s and
its RAM arm panics).  The blocker is that barretenberg's builder computes
VALUES while building — ROM reads index the table, and finalize SORTS the
records — which under MPC are secret-data-dependent.  This module makes the
builder value-generic:

  * every builder variable is either a public int (as before) or a ShVal —
    an (L, 1) share handle from an MPC driver;
  * FieldCT affine ops stay LOCAL on shares;
  * ROM reads with a shared index become LUT reads over the table's value
    handles (mpc/lut.py — one batched eq+mul round);
  * process_ROM_array's sort becomes an OBLIVIOUS bitonic network keyed by
    [index * R + creation_rank] (distinct keys => the unique ascending
    order equals the plain prover's stable sort, so proof bytes match);
    each network stage is ONE batched compare round + ONE batched swap
    round across every record field;
  * the reference's index-pinning quirk (WitnessCT::from_field pins the
    runtime index value into a CONSTANT — i.e. into the public q_c
    selector) is skipped in provider mode: with a secret index it would
    leak the index into the verification key.  The plain-driver provider
    skips it identically, so plain-vs-MPC byte comparisons stay valid.

The circuit STRUCTURE (gate counts, copy cycles, tags) is value-
independent in provider mode: a proving key built from any party's
zero-valued builder matches every other party's.
"""

from __future__ import annotations

import numpy as np

from ..mpc.driver import as_index
from ..ops.curve import leaves, pmap


class ShVal:
    """A builder-variable value living in MPC share space ((L, 1) vec)."""

    __slots__ = ("h",)

    def __init__(self, h):
        self.h = h


def _col(x):
    """(L,) share -> (L, 1) share."""
    return pmap(lambda c: c[:, None] if c.dim() == 1 else c, x)


def _first_int(f, handle) -> int:
    """The first element of a public (plain-driver) handle, as an int."""
    return int(f.decode(leaves(handle)[0][:, :1])[0])


class MpcBuilderValues:
    """Value provider bound to an MPC driver + the ACIR witness share vec."""

    def __init__(self, driver, witness_share):
        self.d = driver
        self.w = witness_share
        self.varnum = leaves(witness_share)[0].shape[-1]
        self.extra: dict[int, object] = {}  # var idx -> (L, 1) share handle
        # access-type shares for oblivious-sorted RAM rows, in row order
        # (builder.memory_mixed_rows); the co-prover adds them into w_4
        self.mixed_access: list = []
        self.f = driver.fr
        self.plain = driver.protocol == "plain"
        self._lut = None

    # ------------------------------------------------------------- handles

    def is_shared(self, idx: int) -> bool:
        return idx < self.varnum or idx in self.extra

    def get(self, idx: int):
        if idx in self.extra:
            return self.extra[idx]
        return self.d.slice_share(self.w, idx, idx + 1)

    def register(self, idx: int, handle):
        self.extra[idx] = _col(handle)

    def handle_of(self, idx: int, builder):
        """Share handle for any witness index (publics promoted)."""
        if self.is_shared(idx):
            return self.get(idx)
        return self.d.promote_public(self.f.encode([builder.get_variable(idx)]))

    def value_vec(self, widxs: list[int], builder):
        """Witness indices -> one (L, n) share vec (publics promoted)."""
        return self.d.concat_shares(*(self.handle_of(wi, builder) for wi in widxs))

    # ------------------------------------------------------------- algebra

    def affine(self, handle, mul: int, add: int):
        """mul * h + add with public constants (local)."""
        d = self.d
        out = handle
        if mul % self.f.p != 1:
            out = d.mul_public(out, self.f.const_mont(mul % self.f.p)[:, None])
        if add % self.f.p != 0:
            out = d.add_public(out, self.f.const_mont(add % self.f.p)[:, None])
        return out

    # ------------------------------------------------------------- ROM ops

    def rom_read(self, state_widxs: list[int], index_widx: int, builder):
        """Oblivious table[index] over the table's value handles."""
        d = self.d
        vals = self.value_vec(state_widxs, builder)
        needle = self.get(index_widx)
        if self.plain:
            i = _first_int(self.f, needle)
            return d.slice_share(vals, i, i + 1)
        lut = self._get_lut()
        m = lut.init_map_public_keys(vals)
        return _col(lut.read(d.index_share(needle, 0), m))

    def _get_lut(self):
        if self._lut is None:
            from ..mpc.lut import Rep3Lut

            self._lut = Rep3Lut(self.d)
        return self._lut

    # ------------------------------------------------------------- RAM ops
    # The RAM state lives as a share map once any access index is secret;
    # reads/writes are the LUT's constant-round oblivious ops.

    def ram_state_init(self, state_widxs: list[int], builder):
        vals = self.value_vec(state_widxs, builder)
        if self.plain:
            return {"vals": vals}
        return {"map": self._get_lut().init_map_public_keys(vals)}

    def ram_read(self, state, index_widx: int, builder):
        d = self.d
        needle = self.handle_of(index_widx, builder)
        if self.plain:
            i = _first_int(self.f, needle)
            return d.slice_share(state["vals"], i, i + 1)
        lut = self._get_lut()
        return _col(lut.read(d.index_share(needle, 0), state["map"]))

    def ram_write(self, state, index_widx: int, value_widx: int, builder):
        d = self.d
        needle = self.handle_of(index_widx, builder)
        value = self.value_vec([value_widx], builder)
        if self.plain:
            i = _first_int(self.f, needle)
            state["vals"] = _scatter(state["vals"], np.asarray([i]), value)
            return
        lut = self._get_lut()
        state["map"] = lut.write(d.index_share(needle, 0),
                                 d.index_share(value, 0), state["map"])

    def same_bits(self, a, b):
        """Arithmetic 0/1 shares of a_i == b_i (elementwise vectors)."""
        d = self.d
        if self.plain:
            da = self.f.decode(leaves(a)[0])
            db = self.f.decode(leaves(b)[0])
            return d.promote_public(self.f.encode(
                [1 if int(x) == int(y) else 0 for x, y in zip(da, db)]))
        bit = d.binary.is_zero(d.binary.a2b(d.sub(a, b)))
        return d.binary.bit_inject(bit)

    # -------------------------------------------------------- oblivious sort

    def sort_records(self, keys, fields):
        """Sort records ascending by DISTINCT shared keys; `fields` is a
        list of (L, R) share vecs permuted alongside.  Returns sorted
        fields.  One compare + one swap round per bitonic stage, batched
        across the stage's pairs and across all fields."""
        d = self.d
        R = leaves(keys)[0].shape[-1]
        if self.plain:
            raw = [int(v) for v in self.f.decode(leaves(keys)[0])]
            order = np.argsort(np.asarray(raw, dtype=object), kind="stable")
            idx = order.astype(np.int64)
            return [d.gather(fv, idx) for fv in fields]
        Rp = 1
        while Rp < R:
            Rp <<= 1
        if Rp != R:
            # pad with +inf keys (any public value above every real key)
            pad = d.promote_public(self.f.encode([1 << 240] * (Rp - R)))
            keys = d.concat_shares(keys, pad)
            zpad = d.promote_public(self.f.encode([0] * (Rp - R)))
            fields = [d.concat_shares(fv, zpad) for fv in fields]
        for i_idx, j_idx in _bitonic_stages(Rp):
            I = np.asarray(i_idx, np.int64)
            J = np.asarray(j_idx, np.int64)
            ka = d.gather(keys, I)
            kb = d.gather(keys, J)
            # swap when key[I] > key[J]; keys distinct => gt == !(kb >= ka)
            ge = d.binary.bit_inject(d.binary.unsigned_ge(kb, ka))
            one = d.promote_public(self.f.one_mont(leaves(ge)[0].shape[1:]).contiguous())
            swap = d.sub(one, ge)
            vecs = [keys] + fields
            cat_a = d.concat_shares(*(d.gather(v, I) for v in vecs))
            cat_b = d.concat_shares(*(d.gather(v, J) for v in vecs))
            nrep = len(vecs)
            swap_rep = d.concat_shares(*([swap] * nrep))
            delta = d.mul_vec(swap_rep, d.sub(cat_a, cat_b))  # one round
            new_a = d.sub(cat_a, delta)
            new_b = d.add(cat_b, delta)
            npairs = len(i_idx)
            out = []
            for k, v in enumerate(vecs):
                lo = k * npairs
                v = _scatter(v, I, d.slice_share(new_a, lo, lo + npairs))
                v = _scatter(v, J, d.slice_share(new_b, lo, lo + npairs))
                out.append(v)
            keys, fields = out[0], out[1:]
        return [d.slice_share(fv, 0, R) for fv in fields]


def _scatter(vec, idx, vals):
    """Copy of vec with columns idx set to vals (per share component)."""
    def put(base, v):
        out = base.clone()
        out[:, as_index(idx, base.device)] = v
        return out

    return pmap(put, vec, vals)


def _bitonic_stages(n: int):
    """Bitonic sorting network for power-of-two n: per stage, disjoint
    (min_slot, max_slot) pair lists."""
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            lo, hi = [], []
            for i in range(n):
                partner = i ^ j
                if partner > i:
                    if (i & k) == 0:
                        lo.append(i)
                        hi.append(partner)
                    else:
                        lo.append(partner)
                        hi.append(i)
            stages.append((lo, hi))
            j //= 2
        k *= 2
    return stages
