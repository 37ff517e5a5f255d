"""REP3: 3-party replicated secret sharing over torch limb tensors.

Party i holds (a = x_i, b = x_{i-1}) of x = x0 + x1 + x2.
  * PRF setup: each party samples a seed and sends it to the next party ->
    correlated streams (self, prev) that always advance in lockstep.
  * mul = 3-term local cross product + zero-masked reshare (one round)
  * open = send b next / recv prev
  * MSM/FFT are share-local per component

All share payloads are Montgomery limb tensors (L, N); whole vectors are
batched into ONE round.  The binary domain (a2b, comparisons, bit circuits)
is `Rep3Driver.binary` (mpc/rep3_binary.py); `sqrt_many` and
`inv_many_guarded` serve the witness-extension VM.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..fields.params import CurveParams
from ..ops.curve import CurveOps, ProjPoint, pmap
from ..ops.field import Field, broadcast_shapes
from ..utils.chacha import ChaChaStream, fresh_seed
from .driver import Driver, as_index, inverse, scalar_mul_many, segment_sum_mont
from .net import Network


class Rep3FieldShare(NamedTuple):
    a: Any  # (L, *batch)
    b: Any


class Rep3PointShare(NamedTuple):
    a: ProjPoint
    b: ProjPoint


class Rep3Rngs:
    """Correlated ChaCha12 streams keyed with the exchanged 256-bit seeds.
    Domains (the counter-mode nonce word) separate independent sub-streams
    of the same pairwise seed:
      0: main rand (masking, random shares)
      1: bitcomp (b2a's correlated field elements)
      2: binary masks (XOR zero-sharings)
    The streams live on `device`: the card unless named."""

    def __init__(self, seed_self: bytes | int, seed_prev: bytes | int, device=None):
        self.rng1 = ChaChaStream(seed_self, domain=0, device=device)
        self.rng2 = ChaChaStream(seed_prev, domain=0, device=device)
        self.bit1 = ChaChaStream(seed_self, domain=1, device=device)
        self.bit2 = ChaChaStream(seed_prev, domain=1, device=device)
        self.bin1 = ChaChaStream(seed_self, domain=2, device=device)
        self.bin2 = ChaChaStream(seed_prev, domain=2, device=device)

    def random_fes(self, f: Field, shape=()):
        """(r_self, r_prev) — a valid random share pair."""
        return self.rng1.rand_mont(f, shape), self.rng2.rand_mont(f, shape)

    def masking_field(self, f: Field, shape=()):
        """r_self - r_prev: sums to zero over the 3 parties."""
        a, b = self.random_fes(f, shape)
        return f.sub(a, b)

    def binary_mask(self, f: Field, nbits: int, shape=()):
        """r_self ^ r_prev over nbits: XORs to zero over the 3 parties."""
        return self.binary_masks(f, nbits, shape, 1)[0]

    def binary_masks(self, f: Field, nbits: int, shape=(), n: int = 1):
        """n zero-XOR masks of (L, *shape) int32 limbs, the top limb cut to
        nbits - 32 (L - 1) bits.  Each mask takes ceil(L * size / 16) blocks
        of both streams and the n draws follow each other: every party makes
        the same requests, so the correlated streams stay in lockstep."""
        L = f.L
        total = 1
        for s in shape:
            total *= s
        per = max(1, -(-(L * total) // 16)) * 16

        def draw(stream):
            return stream.words((n, per))[:, : L * total]

        w = draw(self.bin1) ^ draw(self.bin2)
        w = w.reshape((n, L) + tuple(shape))
        top_bits = nbits - 32 * (L - 1)
        w[:, L - 1] &= (1 << top_bits) - 1 if top_bits > 0 else 0
        w = w.to(torch.int32)
        return [w[i] for i in range(n)]


def share_field_vec(f: Field, vec_mont, seed: bytes | int | None = None):
    """Dealer-side: split (L, N) Montgomery values into 3 REP3 shares.

    Mask entropy is a 256-bit ChaCha key (fresh OS entropy unless a test
    passes an explicit seed, which is SHA-256-expanded)."""
    stream = ChaChaStream(fresh_seed() if seed is None else seed, domain=0,
                          device=vec_mont.device)
    batch = vec_mont.shape[1:]
    x0 = stream.rand_mont(f, batch)
    x1 = stream.rand_mont(f, batch)
    x2 = f.sub(f.sub(vec_mont, x0), x1)
    return [
        Rep3FieldShare(x0, x2),
        Rep3FieldShare(x1, x0),
        Rep3FieldShare(x2, x1),
    ]


def combine_field_shares(f: Field, shares: list[Rep3FieldShare]):
    return f.add(f.add(shares[0].a, shares[1].a), shares[2].a)


class Rep3Driver(Driver):
    protocol = "rep3"

    def __init__(self, curve: CurveParams, net: Network, device=None, devices=None):
        super().__init__(curve, device=device, devices=devices)
        self.net = net
        self.id = net.id
        # PRF setup: exchange 256-bit seeds with the next party
        seed_self = fresh_seed()
        net.send_next(seed_self)
        seed_prev = bytes(net.recv_prev())
        if len(seed_prev) != 32:
            raise ValueError("PRF setup: peer seed must be 32 bytes")
        self.rngs = Rep3Rngs(seed_self, seed_prev, device=self.device)

    @property
    def binary(self):
        """Binary-domain ops (a2b, comparisons, bit circuits)."""
        if not hasattr(self, "_binary"):
            from .rep3_binary import Rep3Binary

            self._binary = Rep3Binary(self)
        return self._binary

    def _recv_tensor(self, obj):
        return pmap(lambda t: t.to(self.device), obj)

    # ------------------------------------------------------- share algebra

    def promote_public(self, vals_mont):
        z = torch.zeros_like(vals_mont)
        if self.id == 0:
            return Rep3FieldShare(vals_mont, z)
        if self.id == 1:
            return Rep3FieldShare(z, vals_mont)
        return Rep3FieldShare(z, z)

    def add(self, x: Rep3FieldShare, y: Rep3FieldShare):
        return Rep3FieldShare(self.fr.add(x.a, y.a), self.fr.add(x.b, y.b))

    def sub(self, x, y):
        return Rep3FieldShare(self.fr.sub(x.a, y.a), self.fr.sub(x.b, y.b))

    def neg(self, x):
        return Rep3FieldShare(self.fr.neg(x.a), self.fr.neg(x.b))

    def add_public(self, x: Rep3FieldShare, p):
        if self.id == 0:
            return Rep3FieldShare(self.fr.add(x.a, p), x.b)
        if self.id == 1:
            return Rep3FieldShare(x.a, self.fr.add(x.b, p))
        return x

    def mul_public(self, x, p):
        return Rep3FieldShare(self.fr.mont_mul(x.a, p), self.fr.mont_mul(x.b, p))

    def _masked_product(self, x: Rep3FieldShare, y: Rep3FieldShare):
        """This party's additive share of x*y: the 3-term cross product plus
        a zero-sharing mask.  A long vector is formed a piece of the mask
        draw at a time, so no full-length temporary is made."""
        f = self.fr
        batch = broadcast_shapes(x.a.shape[1:], y.a.shape[1:])

        def cross(xa, xb, ya, yb):
            local = f.mont_mul(xa, ya)
            local = f.add(local, f.mont_mul(xa, yb))
            return f.add(local, f.mont_mul(xb, ya))

        n = batch[0] if len(batch) == 1 else 0
        if 2 * f.L * n <= self.rngs.rng1.PIECE:
            return f.add(cross(x.a, x.b, y.a, y.b), self.rngs.masking_field(f, batch))
        shape = (f.L, n)
        xa, xb, ya, yb = (t.expand(shape) for t in (x.a, x.b, y.a, y.b))
        out = torch.empty(shape, dtype=torch.int32, device=self.device)
        for (c0, c1, m1), (_, _, m2) in zip(self.rngs.rng1.rand_mont_pieces(f, n),
                                            self.rngs.rng2.rand_mont_pieces(f, n)):
            cols = slice(c0, c1)
            out[:, cols] = f.add(cross(xa[:, cols], xb[:, cols], ya[:, cols], yb[:, cols]),
                                 f.sub(m1, m2))
        return out

    def mul_vec(self, x: Rep3FieldShare, y: Rep3FieldShare):
        """ONE communication round for the whole vector."""
        local = self._masked_product(x, y)
        del x, y  # the operands may be the largest tensors alive
        self.net.send_next(local)
        prev = self._recv_tensor(self.net.recv_prev())
        return Rep3FieldShare(local, prev)

    mul = mul_vec

    def mul_open_many(self, x, y):
        """x*y opened to all parties: ONE round."""
        local = self._masked_product(x, y)
        self.net.send_next(local)
        self.net.send_prev(local)
        t_prev = self._recv_tensor(self.net.recv_prev())
        t_next = self._recv_tensor(self.net.recv_next())
        return self.fr.add(self.fr.add(local, t_prev), t_next)

    def inv_many(self, x: Rep3FieldShare):
        """Masked-open inversion, 2 rounds.  The opened r*x is 0 exactly when
        x is 0, so every party learns whether a secret was zero; like the
        upstream protocol, a zero denominator aborts."""
        r = self.rand(x.a.shape[1:])
        ry = self.mul_open_many(r, x)
        if not bool(ry.any(dim=0).all()):
            raise ZeroDivisionError("MPC inversion of a zero share (leaks zero-ness "
                                    "by construction; the upstream protocol errors too)")
        return self.mul_public(r, inverse(self.fr, ry))

    def inv_many_guarded(self, x: Rep3FieldShare):
        """Like inv_many but maps 0 -> 0 instead of aborting: the VM's
        guarded division (x / 0 -> 0 on lanes whose secret branch is
        untaken, as circom-mpc-vm guards divisors).  Zero-ness of each lane
        is still revealed, which the masked-open construction cannot avoid."""
        r = self.rand(x.a.shape[1:])
        ry = self.mul_open_many(r, x)
        return self.mul_public(r, inverse(self.fr, ry))

    def sqrt_many(self, x: Rep3FieldShare):
        """Masked-open square root (upstream rep3.rs:400-447): open r^2 x
        and r_squ r_inv in ONE round, take the public root on the host,
        unmask with r_inv (r_squ r_inv)^-1.  Returns SOME root; the caller
        fixes the sign (r^2 x is uniform over the squares and leaks nothing)."""
        from ..vm.mpc_vm import tonelli_shanks

        f = self.fr
        n = x.a.shape[1]
        r_squ = self.rand((n,))
        r_inv = self.rand((n,))
        rr = self.mul_vec(r_squ, r_squ)
        opened = self.mul_open_many(self.concat(rr, r_squ), self.concat(x, r_inv))
        roots = []
        for v in f.from_limbs(f.from_mont(opened[:, :n])):
            r = tonelli_shanks(int(v), f.p)
            if r is None:
                raise ValueError("MPC sqrt: value is a non-residue")
            roots.append(r)
        y_sq = f.encode(roots)
        y_inv = inverse(f, opened[:, n:].contiguous())
        return self.mul_public(self.mul_public(r_inv, y_inv), y_sq)

    def rand(self, shape=()):
        a, b = self.rngs.random_fes(self.fr, shape)
        return Rep3FieldShare(a, b)

    def open_many(self, x: Rep3FieldShare):
        self.net.send_next(x.b)
        c = self._recv_tensor(self.net.recv_prev())
        return self.fr.add(self.fr.add(x.a, x.b), c)

    open = open_many

    def gather(self, x: Rep3FieldShare, idx):
        idx = as_index(idx, x.a.device)
        return Rep3FieldShare(x.a.index_select(1, idx), x.b.index_select(1, idx))

    def concat(self, *vecs):
        return Rep3FieldShare(
            torch.cat([v.a for v in vecs], dim=1),
            torch.cat([v.b for v in vecs], dim=1),
        )

    slice = Driver.slice_share

    def set_slice(self, x, lo, values: Rep3FieldShare):
        n = values.a.shape[1]
        a, b = x.a.clone(), x.b.clone()
        a[:, lo: lo + n] = values.a
        b[:, lo: lo + n] = values.b
        return Rep3FieldShare(a, b)

    def segment_sum(self, values: Rep3FieldShare, seg_ids, num_segments):
        ids = as_index(seg_ids, values.a.device)
        return Rep3FieldShare(
            segment_sum_mont(self.fr, values.a, ids, num_segments),
            segment_sum_mont(self.fr, values.b, ids, num_segments),
        )

    # ------------------------------------------------------------- FFT

    def fft(self, x: Rep3FieldShare):
        return Rep3FieldShare(self.ntt.ntt(x.a), self.ntt.ntt(x.b))

    def ifft(self, x):
        return Rep3FieldShare(self.ntt.intt(x.a), self.ntt.intt(x.b))

    def coset_shift(self, x, g=None):
        return Rep3FieldShare(
            self.ntt.coset_shift(x.a, g), self.ntt.coset_shift(x.b, g)
        )

    # ------------------------------------------------------------- EC

    def to_scalars(self, x: Rep3FieldShare):
        return Rep3FieldShare(self.fr.from_mont(x.a), self.fr.from_mont(x.b))

    def msm_g1(self, points: ProjPoint, share_vec: Rep3FieldShare):
        return self._msm(self.msm_g1_engine, points, share_vec)

    def msm_g2(self, points, share_vec):
        return self._msm(self.msm_g2_engine, points, share_vec)

    def msm_g1_many(self, points: ProjPoint, share_vecs: list) -> list:
        """One G1 MSM a share vector over the same points: both components
        of every share through one engine call."""
        scal = [self.to_scalars(s) for s in share_vecs]
        res = self.msm_g1_engine.msm_many(points, [c for s in scal for c in (s.a, s.b)])
        return [Rep3PointShare(pmap(lambda c, i=i: c[..., 2 * i], res),
                               pmap(lambda c, i=i: c[..., 2 * i + 1], res))
                for i in range(len(scal))]

    def _msm(self, engine, points, share_vec):
        """Both share components through one engine call: the waves run per
        component, bucket reduction and Horner once for the two."""
        s = self.to_scalars(share_vec)
        res = engine.msm_many(points, [s.a, s.b])
        return Rep3PointShare(pmap(lambda c: c[..., 0], res),
                              pmap(lambda c: c[..., 1], res))

    def scalar_mul_public_point(self, ops: CurveOps, point: ProjPoint, share):
        s = self.to_scalars(share)
        ra, rb = scalar_mul_many(ops, [point, point], [s.a, s.b])
        return Rep3PointShare(ra, rb)

    def _generator(self, ops: CurveOps) -> ProjPoint:
        gen = ops.encode_points(
            [self.curve.g1_gen if ops is self.g1 else self.curve.g2_gen])
        return pmap(lambda c: c[..., 0], gen)

    def scalar_mul(self, ops: CurveOps, pt: Rep3PointShare, s: Rep3FieldShare):
        """Shared point x shared scalar: 1 round.  The three cross terms and
        the zero-sharing mask m*G run as one batched double-and-add."""
        f = self.fr
        m = self.rngs.masking_field(f, tuple(s.a.shape[1:]))
        sa, sb, sm = f.from_mont(s.a), f.from_mont(s.b), f.from_mont(m)
        t1, t2, t3, mask = scalar_mul_many(
            ops, [pt.a, pt.b, pt.a, self._generator(ops)], [sa, sa, sb, sm])
        local = ops.add(ops.add(t1, t2), ops.add(t3, mask))
        self.net.send_next(local)
        prev = self._recv_tensor(self.net.recv_prev())
        return Rep3PointShare(local, ProjPoint(*prev))

    def point_add(self, ops: CurveOps, x: Rep3PointShare, y: Rep3PointShare):
        return Rep3PointShare(ops.add(x.a, y.a), ops.add(x.b, y.b))

    def point_sub(self, ops, x, y):
        return Rep3PointShare(
            ops.add(x.a, ops.neg(y.a)), ops.add(x.b, ops.neg(y.b))
        )

    def point_add_public(self, ops: CurveOps, x: Rep3PointShare, p: ProjPoint):
        if self.id == 0:
            return Rep3PointShare(ops.add(x.a, p), x.b)
        if self.id == 1:
            return Rep3PointShare(x.a, ops.add(x.b, p))
        return x

    def open_point(self, ops: CurveOps, x: Rep3PointShare):
        self.net.send_next(x.b)
        c = self._recv_tensor(self.net.recv_prev())
        return ops.add(ops.add(x.a, x.b), ProjPoint(*c))

    def open_two_points(self, x: Rep3PointShare, y: Rep3PointShare):
        self.net.send_next((x.b, y.b))
        cx, cy = self._recv_tensor(self.net.recv_prev())
        g1 = self.g1.add(self.g1.add(x.a, x.b), ProjPoint(*cx))
        g2 = self.g2.add(self.g2.add(y.a, y.b), ProjPoint(*cy))
        return g1, g2
