"""REP3 binary domain: XOR-shares, AND rounds, Kogge-Stone arithmetic.

Parity: the upstream mpc-core/src/protocols/rep3/a2b.rs, the machinery
behind secret comparisons, shifts and bit ops:
  * Rep3BinaryShare: XOR-sharing x = x0 ^ x1 ^ x2 packed as (Lb, *batch)
    tensors of 32-bit limbs in int32, least significant limb first
  * and_ / and_twice: one masked AND round (both ANDs of a Kogge-Stone
    level ride ONE message)
  * kogge_stone_inner: log-depth carry propagation (a2b.rs:286)
  * a2b: arithmetic -> binary via one masked reshare + binary add mod p
    (a2b.rs:367)
  * unsigned_ge / cmux / bit_inject / b2a: results back to arithmetic

A binary share holds bitlen + 2 bits (Lb = ceil((bitlen + 2) / 32) limbs):
a2b adds two values below p (bitlen + 1 bits) and `sub_p_cmux` reads the
carry out of a (bitlen + 1)-bit sum at bit bitlen + 1.  That is 8 limbs over
BN254 Fr (254 bits) and 9 over BLS12-381 Fr (255 bits).  The JAX package
holds 256 bits whatever the field, which loses that carry over BLS12-381 Fr.

Every shift works on int64 copies of the limbs masked to 32 bits: `>>` on a
negative int32 would shift in ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.field import M32, Field, broadcast_shapes, ints_to_limbs_np, u64


class Rep3BinaryShare(NamedTuple):
    a: torch.Tensor  # (Lb, *batch) int32, 32-bit limbs
    b: torch.Tensor


def binary_limbs(bitlen: int) -> int:
    """32-bit limbs of a binary share over a field of `bitlen` bits."""
    return -(-(bitlen + 2) // 32)


def shl_bits(x: torch.Tensor, s: int) -> torch.Tensor:
    """Left shift of (Lb, *batch) 32-bit limbs by s bits (overflow dropped)."""
    if s == 0:
        return x
    w, b = divmod(s, 32)
    u = u64(x)
    xr = torch.zeros_like(u)
    if w < u.shape[0]:
        xr[w:] = u[: u.shape[0] - w]
    if b:
        carry = torch.zeros_like(xr)
        carry[1:] = xr[:-1] >> (32 - b)
        xr = ((xr << b) & M32) | carry
    return xr.to(torch.int32)


def shr_bits(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of (Lb, *batch) 32-bit limbs by s bits."""
    if s == 0:
        return x
    w, b = divmod(s, 32)
    u = u64(x)
    xr = torch.zeros_like(u)
    if w < u.shape[0]:
        xr[: u.shape[0] - w] = u[w:]
    if b:
        carry = torch.zeros_like(xr)
        carry[:-1] = (xr[1:] << (32 - b)) & M32
        xr = (xr >> b) | carry
    return xr.to(torch.int32)


def _and_local(xa, xb, ya, yb, mask):
    """This party's share of x & y before the reshare, masked."""
    return (xa & ya) ^ (xa & yb) ^ (xb & ya) ^ mask


class Rep3Binary:
    """Binary-domain protocol ops bound to a Rep3Driver."""

    def __init__(self, driver):
        self.d = driver
        self.f: Field = driver.fr
        self.bitlen = driver.curve.fr.p.bit_length()
        self.L = binary_limbs(self.bitlen)
        self.device = driver.device
        self._consts: dict = {}

    # ------------------------------------------------------------ helpers

    def const(self, v: int) -> torch.Tensor:
        """python int -> (Lb,) int32 limbs on the driver's device."""
        if v not in self._consts:
            arr = ints_to_limbs_np(v, self.L).view("int32")
            self._consts[v] = torch.from_numpy(arr.copy()).to(self.device)
        return self._consts[v]

    def _bc(self, v: int, batch) -> torch.Tensor:
        """The constant v shaped to broadcast against a (Lb, *batch) share."""
        return self.const(v).reshape((self.L,) + (1,) * len(batch))

    def _maskc(self, nbits: int, batch) -> torch.Tensor:
        return self._bc((1 << nbits) - 1, batch)

    def to_bits(self, x: torch.Tensor) -> torch.Tensor:
        """(L, *batch) canonical field limbs -> (Lb, *batch) binary limbs."""
        pad = self.L - x.shape[0]
        if pad == 0:
            return x
        return torch.cat([x, torch.zeros_like(x[:pad])], dim=0)

    def from_bits(self, x: torch.Tensor) -> torch.Tensor:
        """(Lb, *batch) limbs of a value below 2^(32 L) -> (L, *batch)."""
        return x[: self.f.L]

    def _rand_mask(self, batch):
        """r_self ^ r_prev over bitlen bits (zero-sum XOR mask; ChaCha12)."""
        return self.to_bits(self.d.rngs.binary_mask(self.f, self.bitlen, batch))

    def _rand_masks(self, batch, n: int):
        return [self.to_bits(m) for m in
                self.d.rngs.binary_masks(self.f, self.bitlen, batch, n)]

    def _recv(self):
        return self.d._recv_tensor(self.d.net.recv_prev())

    def zeros(self, batch=()) -> Rep3BinaryShare:
        """Two distinct zero tensors: the VM writes into them in place."""
        shape = (self.L,) + tuple(batch)
        return Rep3BinaryShare(*(torch.zeros(shape, dtype=torch.int32, device=self.device)
                                 for _ in range(2)))

    def promote_public(self, pub_bits) -> Rep3BinaryShare:
        """Public (Lb, *batch) standard-form bits as an XOR share: party 0
        holds the value in `a`, party 1 sees it as prev's share in `b`."""
        z = torch.zeros_like(pub_bits)
        if self.d.id == 0:
            return Rep3BinaryShare(pub_bits, z)
        if self.d.id == 1:
            return Rep3BinaryShare(z, pub_bits)
        return Rep3BinaryShare(z, z)

    def xor(self, x: Rep3BinaryShare, y: Rep3BinaryShare):
        return Rep3BinaryShare(x.a ^ y.a, x.b ^ y.b)

    def xor_public(self, x: Rep3BinaryShare, pub):
        if self.d.id == 0:
            return Rep3BinaryShare(x.a ^ pub, x.b)
        if self.d.id == 1:
            return Rep3BinaryShare(x.a, x.b ^ pub)
        return x

    def and_public(self, x: Rep3BinaryShare, pub):
        return Rep3BinaryShare(x.a & pub, x.b & pub)

    def shl(self, x, s):
        return Rep3BinaryShare(shl_bits(x.a, s), shl_bits(x.b, s))

    def shr(self, x, s):
        return Rep3BinaryShare(shr_bits(x.a, s), shr_bits(x.b, s))

    # ------------------------------------------------------------ AND round

    def and_(self, x: Rep3BinaryShare, y: Rep3BinaryShare) -> Rep3BinaryShare:
        batch = broadcast_shapes(x.a.shape[1:], y.a.shape[1:])
        local = _and_local(x.a, x.b, y.a, y.b, self._rand_mask(batch))
        self.d.net.send_next(local)
        return Rep3BinaryShare(local, self._recv())

    def and_twice(self, a, b1, b2):
        """(b1 & a, a & b2) in ONE round (a2b.rs:168)."""
        m1, m2 = self._rand_masks(a.a.shape[1:], 2)
        l1 = _and_local(b1.a, b1.b, a.a, a.b, m1)
        l2 = _and_local(a.a, a.b, b2.a, b2.b, m2)
        self.d.net.send_next((l1, l2))
        p1, p2 = self._recv()
        return Rep3BinaryShare(l1, p1), Rep3BinaryShare(l2, p2)

    # ------------------------------------------------------------ adder

    def kogge_stone_inner(self, p, g, bit_len: int) -> Rep3BinaryShare:
        """ceil(log2(bit_len)) levels, each one mask-pair draw and one
        message carrying both ANDs of the level (a2b.rs:286)."""
        depth = max(bit_len - 1, 0).bit_length()
        s_ = p
        batch = p.a.shape[1:]
        for i in range(depth):
            shift = 1 << i
            m1, m2 = self._rand_masks(batch, 2)
            maskc = self._maskc(bit_len - shift, batch)
            pma, pmb = p.a & maskc, p.b & maskc
            gma, gmb = g.a & maskc, g.b & maskc
            psa, psb = shr_bits(p.a, shift), shr_bits(p.b, shift)
            l1 = _and_local(gma, gmb, psa, psb, m1)
            l2 = _and_local(psa, psb, pma, pmb, m2)
            self.d.net.send_next((l1, l2))
            r1b, r2b = self._recv()
            p = Rep3BinaryShare(shl_bits(l2, shift), shl_bits(r2b, shift))
            g = Rep3BinaryShare(g.a ^ shl_bits(l1, shift), g.b ^ shl_bits(r1b, shift))
        return Rep3BinaryShare(shl_bits(g.a, 1) ^ s_.a, shl_bits(g.b, 1) ^ s_.b)

    def binary_add(self, x1, x2, bit_len=None) -> Rep3BinaryShare:
        bl = bit_len or self.bitlen
        p = self.xor(x1, x2)
        g = self.and_(x1, x2)
        return self.kogge_stone_inner(p, g, bl)

    def binary_sub(self, x1, x2) -> Rep3BinaryShare:
        """2^bitlen + x1 - x2 (two's complement add, cin = 1) (a2b.rs:215)."""
        bl = self.bitlen
        batch = x1.a.shape[1:]
        x2n = self.xor_public(x2, self._maskc(bl, batch))
        p = self.xor(x1, x2n)
        g = self.and_(x1, x2n)
        onec = self._bc(1, batch)
        g = self.xor(g, self.and_public(p, onec))
        res = self.kogge_stone_inner(p, g, bl)
        return self.xor_public(res, onec)

    def binary_sub_p(self, x) -> Rep3BinaryShare:
        """x + (2^(bitlen+1) - p) (a2b.rs:276)."""
        bl = self.bitlen
        pc = self._bc((1 << (bl + 1)) - self.f.p, x.a.shape[1:])
        p = self.xor_public(x, pc)
        g = self.and_public(x, pc)
        return self.kogge_stone_inner(p, g, bl + 1)

    def cmux(self, c, x_t, x_f) -> Rep3BinaryShare:
        x = self.xor(x_t, x_f)
        a = self.and_(c, x)
        return self.xor(a, x_f)

    def sub_p_cmux(self, x) -> Rep3BinaryShare:
        """Reduce a sum below 2p into [0, p) (a2b.rs:328)."""
        bl = self.bitlen
        batch = x.a.shape[1:]
        maskc = self._maskc(bl, batch)
        x_msb = self.shr(x, bl)
        x = self.and_public(x, maskc)
        y = self.binary_sub_p(x)
        y_msb = self.shr(y, bl + 1)
        y = self.and_public(y, maskc)
        # (x_msb ^ y_msb) & 1 spread to a full-width mask, componentwise
        ov_a = (x_msb.a[0] ^ y_msb.a[0]) & 1
        ov_b = (x_msb.b[0] ^ y_msb.b[0]) & 1
        ov = Rep3BinaryShare(-ov_a[None] & maskc, -ov_b[None] & maskc)
        return self.cmux(ov, y, x)

    # ------------------------------------------------------------ a2b & co

    def a2b(self, x) -> Rep3BinaryShare:
        """Arithmetic Rep3FieldShare -> binary share of the same value
        (a2b.rs:367): x01 = masked (x0 + x1), x2 injected locally, then a
        binary add mod p.  The components leave the Montgomery domain first
        (the additive relation is linear, so the sharing is kept)."""
        d = self.d
        f = self.f
        batch = x.a.shape[1:]
        xa = f.from_mont(x.a)
        xb = f.from_mont(x.b)
        r = self._rand_mask(batch)
        zero = torch.zeros_like(r)
        if d.id == 0:
            x01_a = r
            x2 = Rep3BinaryShare(zero, self.to_bits(xb))
        elif d.id == 1:
            x01_a = self.to_bits(f.add(xa, xb)) ^ r
            x2 = Rep3BinaryShare(zero, zero)
        else:
            x01_a = r
            x2 = Rep3BinaryShare(self.to_bits(xa), zero)
        d.net.send_next(x01_a)
        x01 = Rep3BinaryShare(x01_a, self._recv())
        summed = self.binary_add(x01, x2, self.bitlen + 1)
        return self.sub_p_cmux(summed)

    def open(self, x: Rep3BinaryShare):
        self.d.net.send_next(x.b)
        return x.a ^ x.b ^ self._recv()

    def unsigned_ge(self, x, y) -> Rep3BinaryShare:
        """[x] >= [y] over field values; a 1-bit binary share (a2b.rs:398)."""
        diff = self.binary_sub(self.a2b(x), self.a2b(y))
        bit = self.shr(diff, self.bitlen)
        return self.and_public(bit, self._bc(1, bit.a.shape[1:]))

    def is_zero(self, x: Rep3BinaryShare) -> Rep3BinaryShare:
        """Binary share -> 1-bit share of (x == 0) by an AND tree over the
        negated bits (a2b.rs:498)."""
        batch = x.a.shape[1:]
        x = self.xor_public(x, self._maskc(self.bitlen, batch))
        length = self.bitlen
        while length > 1:
            if length % 2 == 1:
                # a public padding bit set in BOTH components of EVERY party
                # (1 ^ 1 ^ 1 == 1)
                length += 1
                bitc = self._bc(1 << (length - 1), batch)
                x = Rep3BinaryShare(x.a | bitc, x.b | bitc)
            length //= 2
            mc = self._maskc(length, batch)
            y = self.shr(x, length)
            x = self.and_(self.and_public(x, mc), self.and_public(y, mc))
        return self.and_public(x, self._bc(1, batch))

    def bit_inject(self, x: Rep3BinaryShare):
        """Single-bit binary share -> arithmetic share (a2b.rs:526):
        b0 ^ b1 ^ b2 lifted by two arithmetic XORs (2 mul rounds).  Each
        XOR component x_i is known to parties i (as .a) and i+1 (as .b); as
        0/1 limbs it is a canonical field element already."""
        from .rep3 import Rep3FieldShare

        f = self.f
        own = f.to_mont(self.from_bits(x.a))
        prev = f.to_mont(self.from_bits(x.b))
        zero = torch.zeros_like(own)
        comps = [Rep3FieldShare(zero, zero) for _ in range(3)]
        i = self.d.id
        comps[i] = Rep3FieldShare(own, zero)
        comps[(i - 1) % 3] = Rep3FieldShare(zero, prev)
        t = self.arithmetic_xor(comps[0], comps[1])
        return self.arithmetic_xor(t, comps[2])

    def arithmetic_xor(self, x, y):
        """x + y - 2xy on arithmetic shares (1 mul round)."""
        d = self.d
        prod = d.mul_vec(x, y)
        return d.sub(d.add(x, y), d.add(prod, prod))

    def b2a(self, x: Rep3BinaryShare):
        """General binary -> arithmetic conversion (a2b.rs:440).

        Correlated field elements from the bitcomp ChaCha streams: k2 is
        known to parties {1, 2} (party 1's seed), k3 to parties {2, 0}
        (party 2's seed).  Party 2 injects the bits of k2 + k3 XOR-masked;
        a binary add mod p gives z = x + k2 + k3, which is opened to parties
        0 and 1 only.  Components: c0 = open(z), c1 = -k2, c2 = -k3."""
        from .rep3 import Rep3FieldShare

        d = self.d
        f = self.f
        batch = x.a.shape[1:]
        r = self._rand_mask(batch)
        if d.id == 0:
            k3 = d.rngs.bit2.rand_mont(f, batch)  # party 2's seed stream
            res_b = f.neg(k3)
            ya = r
        elif d.id == 1:
            k2 = d.rngs.bit1.rand_mont(f, batch)  # own seed (shared with 2)
            res_a = f.neg(k2)
            ya = r
        else:
            k2 = d.rngs.bit2.rand_mont(f, batch)  # party 1's seed stream
            k3 = d.rngs.bit1.rand_mont(f, batch)  # own seed (shared with 0)
            ya = self.to_bits(f.from_mont(f.add(k2, k3))) ^ r
            res_a = f.neg(k3)
            res_b = f.neg(k2)
        d.net.send_next(ya)
        y = Rep3BinaryShare(ya, self._recv())
        z = self.sub_p_cmux(self.binary_add(x, y, self.bitlen + 1))
        # partial open of z to parties 0 and 1 (z < 2^bitlen fits L limbs)
        if d.id == 0:
            d.net.send_next(z.b)
            opened = z.a ^ z.b ^ self._recv()
            res_a = f.to_mont(f._cond_sub_p(self.from_bits(opened)))
        elif d.id == 1:
            opened = z.a ^ z.b ^ self._recv()
            res_b = f.to_mont(f._cond_sub_p(self.from_bits(opened)))
        else:
            d.net.send_next(z.b)
        return Rep3FieldShare(res_a, res_b)

    # ------------------------------------------- arithmetic-level bit ops

    def shr_arith(self, x, s: int):
        """[x] >> s with public s (witness_extension_impl.rs:367):
        a2b -> logical shift -> b2a."""
        if s == 0:
            return x
        if s >= self.bitlen:
            from .rep3 import Rep3FieldShare

            z = torch.zeros_like(x.a)
            return Rep3FieldShare(z, z)
        return self.b2a(self.shr(self.a2b(x), s))

    def bitwise_arith(self, op: str, x, y):
        """[x] op [y] for op in band / bor / bxor (one a2b pair, 0-1 AND
        rounds, b2a), as witness_extension_impl.rs:455-560."""
        bx = self.a2b(x)
        by = self.a2b(y)
        if op == "band":
            res = self.and_(bx, by)
        elif op == "bxor":
            res = self.xor(bx, by)
        elif op == "bor":
            res = self.xor(self.xor(bx, by), self.and_(bx, by))
        else:
            raise ValueError(op)
        return self.b2a(res)
