"""Common MPC driver interface + the Plain (no-MPC) driver.

The prover is written ONCE, generic over a driver.  Communication-free
methods are local; methods that need a round go through the driver's
network.  Every driver carries an explicit `device` (default: the card), or
a list `devices` of more than one, in which case its NTT and MSM engines are
the device-sharded ones of parallel/sharded.py and `device` is the first of
the list.

Share-vector representation per driver:
  Plain : raw (L, N) Montgomery limb tensors
  REP3  : Rep3FieldShare(a=(L,N), b=(L,N))
  Shamir: (L, N) (single component, degree-t polynomial share)

Scalars fed to curve ops are ALWAYS converted out of Montgomery form first
(standard-form limbs are what windowed scalar recoding expects).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.params import CurveParams
from ..ops.curve import CurveOps, ProjPoint, g1_ops, g2_ops, leaves, pmap
from ..ops.field import Field, get_field, resolve_device, u64
from ..ops.msm import msm_engine
from ..ops.ntt import ntt_engine


def segment_sum_mont(f: Field, values, seg_ids, num_segments: int):
    """Segment-sum of Montgomery elements (L, N) by (N,) int64 ids: integer
    limb sums in int64 (`index_add_`, exact and order-independent), then one
    fold back to a canonical element."""
    data = u64(values).t().contiguous()  # (N, L)
    sums = torch.zeros((num_segments, f.L), dtype=torch.int64, device=values.device)
    sums.index_add_(0, seg_ids, data)
    return f.reduce_cols(sums.t().contiguous())


def scalar_mul_many(ops: CurveOps, points: list, scalars: list) -> list:
    """Independent scalar multiplications (points and scalars of one batch
    shape each) as ONE double-and-add over a new trailing axis."""
    batch = tuple(scalars[0].shape[1:])
    ln = ops.lane
    pts = [ProjPoint(*(ln.broadcast_to(c, batch) for c in p)) for p in points]
    stacked = pmap(lambda *cs: torch.stack(cs, dim=-1), *pts)
    res = ops.scalar_mul(stacked, torch.stack(scalars, dim=-1))
    return [pmap(lambda c: c[..., i], res) for i in range(len(points))]


def inverse(f: Field, a):
    """Public inverses of (L, *batch) Montgomery elements (0 -> 0): a batch
    inversion along axis 1 when it holds more than one element."""
    return f.batch_inv(a) if a.dim() > 1 and a.shape[1] > 1 else f.inv(a)


def as_index(idx, device) -> torch.Tensor:
    """numpy / tensor integer indices -> int64 tensor on `device`."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(device)


class Driver:
    """Base: holds field/curve engines on one device.  Subclasses define
    share semantics.

    With `devices` (a list of more than one torch device; one device may be
    named several times) the NTT and MSM engines are the SHARDED ones of
    parallel/sharded.py: every prover MSM and (i)NTT is split over the list
    and combined on its first device, bit-exact with the one-device engines.
    Everything else runs on that first device."""

    protocol = "abstract"

    def __init__(self, curve: CurveParams, device=None, devices=None):
        self.curve = curve
        self.devices = None
        if devices is not None:
            if device is not None:
                raise ValueError("give a driver `device` or `devices`, not both")
            devices = tuple(resolve_device(d) for d in devices)
            device = devices[0]
            if len(devices) > 1:
                self.devices = devices
        self.device = resolve_device(device)
        self.fr = get_field(curve.fr.p, curve.name + ".fr", self.device)
        self.fq = get_field(curve.fq.p, curve.name + ".fq", self.device)
        self.g1 = g1_ops(curve, self.device)
        self.g2 = g2_ops(curve, self.device)
        bits = curve.fr.p.bit_length()
        if self.devices is not None:
            from ..parallel.sharded import ShardedMSMEngine, sharded_ntt_engine

            self.ntt = sharded_ntt_engine(self.fr, curve.fr, self.devices)
            self.msm_g1_engine = ShardedMSMEngine(
                lambda d: g1_ops(curve, d), self.devices, scalar_bits=bits)
            self.msm_g2_engine = ShardedMSMEngine(
                lambda d: g2_ops(curve, d), self.devices, scalar_bits=bits)
        else:
            self.ntt = ntt_engine(self.fr, curve.fr)
            self.msm_g1_engine = msm_engine(self.g1, scalar_bits=bits)
            self.msm_g2_engine = msm_engine(self.g2, scalar_bits=bits)

    # ---- helpers shared by drivers ----

    def encode_publics(self, vals):
        return self.fr.encode([int(v) % self.fr.p for v in vals])

    def g1_proj(self, arr) -> ProjPoint:
        """io.zkey.G1Array -> ProjPoint with infinity handling ((0,0))."""
        x = arr.x.to(self.device)
        y = arr.y.to(self.device)
        inf = (x == 0).all(dim=0) & (y == 0).all(dim=0)
        one = self.fq.one_mont(x.shape[1:])
        z = self.fq.select(inf, self.fq.zeros(x.shape[1:]), one)
        y = self.fq.select(inf, one, y)
        return ProjPoint(x, y, z)

    def g2_proj(self, arr) -> ProjPoint:
        x = (arr.x0.to(self.device), arr.x1.to(self.device))
        y = (arr.y0.to(self.device), arr.y1.to(self.device))
        lane = self.g2.lane
        inf = lane.is_zero(x) & lane.is_zero(y)
        batch = tuple(x[0].shape[1:])
        one = lane.one(batch)
        z = lane.select(inf, lane.zeros(batch), one)
        y = lane.select(inf, one, y)
        return ProjPoint(x, y, z)

    def host_g1(self, pt) -> ProjPoint:
        """host affine int tuple (or None) -> single ProjPoint."""
        return self.g1.encode_points([pt])

    def host_g2(self, pt) -> ProjPoint:
        return self.g2.encode_points([pt])

    # ---- generic share helpers (a share is a tensor or a tuple nest of
    # (L, n) limb tensors) ----

    def broadcast_share(self, x, n: int):
        """single share (batch () or (1,)) -> batch (n,)."""
        return pmap(lambda c: (c[:, None] if c.dim() == 1 else c[:, :1]).expand(c.shape[0], n), x)

    def sum_vec(self, x):
        """Reduce a share vector along its batch axis (local, linear)."""
        return pmap(self.fr.sum, x)

    def index_share(self, x, i: int):
        return pmap(lambda c: c[:, i], x)

    def stack_shares(self, xs: list):
        return pmap(lambda *cs: torch.stack(cs, dim=1), *xs)

    def evaluate_poly_public(self, coeffs_share, xi: int):
        """Evaluate a shared polynomial at a public point (local)."""
        from ..ops.ntt import power_table

        n = leaves(coeffs_share)[0].shape[1]
        return self.sum_vec(self.mul_public(coeffs_share, power_table(self.fr, xi, n)))

    def prefix_mul(self, x):
        """Inclusive prefix products of a share vector in constant rounds
        (Ozdemir-Boneh masking): blind with r_i, open r_i x_i r_{i+1}^-1,
        take the public prefix products, unblind with r_0^-1 r_{i+1}."""
        n = leaves(x)[0].shape[1]
        r = self.rand((n + 1,))
        r_inv = self.inv_many(r)
        r_inv0 = self.broadcast_share(self.slice_share(r_inv, 0, 1), n)
        unblind = self.mul_vec(r_inv0, self.slice_share(r, 1, n + 1))
        blinded = self.mul_vec(self.slice_share(r, 0, n), x)
        opened = self.mul_open_many(blinded, self.slice_share(r_inv, 1, n + 1))
        return self.mul_public(unblind, self.fr.cumprod(opened))

    def slice_share(self, x, lo: int, hi: int):
        return pmap(lambda c: c[:, lo:hi], x)

    def concat_shares(self, *xs):
        return pmap(lambda *cs: torch.cat(cs, dim=1), *xs)

    def stack_points(self, pts: list):
        """list of single point-shares -> batched point-share (batch k)."""
        return pmap(lambda *cs: torch.stack(cs, dim=-1), *pts)

    def msm_g1_many(self, points: ProjPoint, share_vecs: list) -> list:
        """One G1 MSM a share vector over the same points, as one engine
        call: bucket reduction and Horner run once for all.  For the drivers
        whose share is one tensor; REP3 overrides it."""
        res = self.msm_g1_engine.msm_many(points, [self.to_scalars(s) for s in share_vecs])
        return [pmap(lambda c, i=i: c[..., i], res) for i in range(len(share_vecs))]


class PlainDriver(Driver):
    """Single-party ground-truth driver."""

    protocol = "plain"

    def __init__(self, curve: CurveParams, seed: int = 0, device=None, devices=None):
        super().__init__(curve, device=device, devices=devices)
        from ..utils.chacha import ChaChaStream

        self._stream = ChaChaStream(seed ^ 0x9E3779B9, domain=0, device=self.device)

    # ---- share algebra ----

    def promote_public(self, vals_mont):
        return vals_mont

    def add(self, a, b):
        return self.fr.add(a, b)

    def sub(self, a, b):
        return self.fr.sub(a, b)

    def neg(self, a):
        return self.fr.neg(a)

    def add_public(self, a, p):
        return self.fr.add(a, p)

    def mul_public(self, a, p):
        return self.fr.mont_mul(a, p)

    def mul_vec(self, a, b):
        return self.fr.mont_mul(a, b)

    def mul(self, a, b):
        return self.fr.mont_mul(a, b)

    def mul_open_many(self, a, b):
        return self.fr.mont_mul(a, b)

    def rand(self, shape=()):
        return self._stream.rand_mont(self.fr, shape)

    def open_many(self, a):
        return a

    open = open_many

    def inv_many(self, a):
        return inverse(self.fr, a)

    def gather(self, vec, idx):
        return vec.index_select(1, as_index(idx, vec.device))

    def concat(self, *vecs):
        return torch.cat(vecs, dim=1)

    slice = Driver.slice_share

    def set_slice(self, vec, lo, values):
        out = vec.clone()
        out[:, lo: lo + values.shape[1]] = values
        return out

    def segment_sum(self, values, seg_ids, num_segments):
        return segment_sum_mont(self.fr, values, as_index(seg_ids, values.device),
                                num_segments)

    # ---- FFT ----

    def fft(self, a):
        return self.ntt.ntt(a)

    def ifft(self, a):
        return self.ntt.intt(a)

    def coset_shift(self, a, g=None):
        return self.ntt.coset_shift(a, g)

    # ---- EC ----

    def to_scalars(self, share_vec):
        """Montgomery share vec -> standard-form limbs for windowing."""
        return self.fr.from_mont(share_vec)

    def msm_g1(self, points: ProjPoint, share_vec):
        return self.msm_g1_engine.msm(points, self.to_scalars(share_vec))

    def msm_g2(self, points: ProjPoint, share_vec):
        return self.msm_g2_engine.msm(points, self.to_scalars(share_vec))

    def scalar_mul_public_point(self, ops: CurveOps, point: ProjPoint, share):
        return scalar_mul_many(ops, [point], [self.to_scalars(share)])[0]

    def scalar_mul(self, ops: CurveOps, point_share, scalar_share):
        return self.scalar_mul_public_point(ops, point_share, scalar_share)

    def point_add(self, ops: CurveOps, a, b):
        return ops.add(a, b)

    def point_add_public(self, ops: CurveOps, a, p):
        return ops.add(a, p)

    def point_sub(self, ops: CurveOps, a, b):
        return ops.add(a, ops.neg(b))

    def open_point(self, ops: CurveOps, a):
        return a

    def open_two_points(self, a, b):
        return a, b
