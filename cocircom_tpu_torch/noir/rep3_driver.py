"""REP3 driver for the ACVM witness solver.

Parity: upstream co-noir/co-acvm/src/solver.rs (Rep3CoSolver) + mpc-core
NoirWitnessExtensionProtocol (traits.rs:291-365: solve_linear_term /
solve_equation / LUT ops / open_many) over the REP3 protocol.

Values crossing the solver boundary follow solver.py's AcvmType
convention: public python ints or Shared(handle) where the handle is a
scalar Rep3FieldShare ((L,) components).  Memory blocks are Rep3Lut
SharedMaps with public position keys (ACVM memory is indexed 0..n-1); a
public index short-circuits to a direct column access, a shared index runs
the constant-round batched LUT read/write (mpc/lut.py).
"""

from __future__ import annotations

from ..mpc.lut import Rep3Lut, SharedMap
from ..mpc.rep3 import Rep3Driver, Rep3FieldShare
from .solver import Shared, is_shared


class _LutHolder:
    """Mutable wrapper (the solver mutates LUTs in place)."""

    __slots__ = ("m",)

    def __init__(self, m: SharedMap):
        self.m = m


class Rep3NoirDriver:
    protocol = "rep3"

    def __init__(self, driver: Rep3Driver):
        self.d = driver
        self.lut = Rep3Lut(driver)
        self.p = driver.curve.fr.p
        self.f = driver.fr

    # ----------------------------------------------------------- scalars

    def _enc_pub(self, c: int):
        return self.f.encode([int(c) % self.p])[:, 0]

    def promote(self, c: int) -> Rep3FieldShare:
        z = self.f.zeros()
        return self.d.add_public(Rep3FieldShare(z, z), self._enc_pub(c))

    def mul_public(self, c: int, x: Rep3FieldShare):
        return self.d.mul_public(x, self._enc_pub(c))

    def mul(self, x, y):
        return self.d.mul_vec(x, y)

    def add(self, x, y):
        return self.d.add(x, y)

    def solve_equation(self, q_l: int, c: int) -> int:
        return (-c) * pow(q_l, -1, self.p) % self.p

    def solve_equation_shared(self, q_l, c):
        """x = -c / q_l with either side shared (traits.rs solve_equation)."""
        if not hasattr(q_l, "a"):
            q_l = self.promote(q_l)
        if not hasattr(c, "a"):
            c = self.promote(c)
        inv = self.d.inv_many(q_l)
        return self.d.neg(self.d.mul_vec(inv, c))

    # --------------------------------------------------------------- LUT

    def _to_share(self, v):
        if is_shared(v):
            return v.v
        return self.promote(int(v))

    def init_lut(self, values: list) -> _LutHolder:
        shares = [self._to_share(v) for v in values]
        stacked = self.d.stack_shares(shares)
        return _LutHolder(self.lut.init_map_public_keys(stacked))

    def read_lut(self, index, holder: _LutHolder):
        if is_shared(index):
            return Shared(self.lut.read(index.v, holder.m))
        return Shared(self.d.index_share(holder.m.values, int(index)))

    def write_lut(self, index, value, holder: _LutHolder):
        val = self._to_share(value)
        if is_shared(index):
            holder.m = self.lut.write(index.v, val, holder.m)
        else:
            i = int(index)
            vals = holder.m.values
            a, b = vals.a.clone(), vals.b.clone()
            a[:, i] = val.a
            b[:, i] = val.b
            holder.m = SharedMap(holder.m.keys, Rep3FieldShare(a, b),
                                 holder.m.public_keys)

    # -------------------------------------------------------------- open

    def open_many(self, shares: list) -> list[int]:
        stacked = self.d.stack_shares(shares)
        return [int(v) for v in self.f.decode(self.d.open_many(stacked))]
