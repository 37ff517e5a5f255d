"""Device sharding: MSM and NTT engines over a list of torch devices.

Points and constraints are data-partitioned over the devices; each device's
part runs on that device's own field, curve, NTT and MSM engines (they are
cached per device), single-point partials and transform blocks are copied
between devices with `tensor.to(device)`, and the result lands on the first
device of the list.  `ShardedMSMEngine` and `ShardedNTTEngine` have the
`.msm` / `.msm_many` and `.ntt` / `.intt` / `.coset_shift` surface of the
local engines, and `mpc.driver.Driver` swaps them in when it is given more
than one device, so `Rep3Driver(curve, net, devices=[...])` sends every
prover MSM and (i)NTT through them.

The list may name one device several times: the shards then run one after
another on that device, which is how the path runs on a single card and how
the CPU tests run it.  Work for different devices is launched one device
after another on that device's current stream, from the calling thread:
there is no process group, because the parties of an in-process MPC run are
threads of one process and share the devices.  With distinct cards the
kernels of different shards overlap as far as the host runs ahead of them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import CurveParams, HostField
from ..ops.curve import CurveOps, ProjPoint, g1_ops, leaves, pmap
from ..ops.field import Field, get_field, resolve_device
from ..ops.msm import msm_engine
from ..ops.ntt import ntt_engine, power_table


def device_list(n_devices: int, device=None) -> list:
    """n_devices torch devices: the named device n times, or (device=None)
    the visible cards in turn, repeated when there are fewer than asked."""
    if device is not None:
        return [resolve_device(device)] * n_devices
    resolve_device(None)  # raises without a card
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def _bounds(total: int, parts: int) -> list:
    """parts + 1 cut points of range(total), as even as integers allow."""
    return [(i * total) // parts for i in range(parts + 1)]


def shard_points(devices, pts: ProjPoint) -> list:
    """Split a batched point along its point axis: one ProjPoint per device."""
    n = leaves(pts)[0].shape[-1]
    cuts = _bounds(n, len(devices))
    return [pmap(lambda c: c[..., lo:hi].to(dev), pts)
            for dev, lo, hi in zip(devices, cuts, cuts[1:])]


# --------------------------------------------------------------- MSM


class ShardedMSMEngine:
    """Drop-in for ops.msm.MSM when the driver holds several devices: points
    and scalars are split along the point axis, each device runs the
    complete-add Pippenger (`MSM._msm_fused`) on its part with the window
    width of ITS point count, the single-point partials are copied to the
    first device and summed there.  Below 4 points per device the local
    engine of the first device takes the whole call."""

    def __init__(self, ops_for, devices, scalar_bits: int | None = None):
        """ops_for(device) -> CurveOps of the group on that device."""
        self.devices = [resolve_device(d) for d in devices]
        self.n_dev = len(self.devices)
        self.scalar_bits = scalar_bits
        self.engines = [msm_engine(ops_for(d), scalar_bits=scalar_bits) for d in self.devices]
        self.local = self.engines[0]
        self.ops: CurveOps = self.local.ops
        # waves run by the last call, over all shards (for measurement scripts)
        self.last_waves = 0

    def msm(self, points: ProjPoint, scalar_limbs, nbits: int | None = None) -> ProjPoint:
        res = self.msm_many(points, [scalar_limbs], nbits)
        return pmap(lambda c: c[..., 0], res)

    def msm_many(self, points: ProjPoint, scalars: list, nbits: int | None = None) -> ProjPoint:
        """k MSMs over the same points; returns a ProjPoint of batch (k,)."""
        n = scalars[0].shape[1]
        nbits = nbits or self.scalar_bits or 32 * scalars[0].shape[0]
        if n < 4 * self.n_dev:
            res = self.local.msm_many(points, scalars, nbits)
            self.last_waves = self.local.last_waves
            return res
        # pad to a device multiple: zero scalars recode to all-zero digits,
        # which never enter a bucket, so the padded lanes contribute nothing
        pad = (-n) % self.n_dev
        if pad:
            scalars = [torch.nn.functional.pad(s, (0, pad)) for s in scalars]
            points = pmap(lambda c: torch.nn.functional.pad(c, (0, pad)), points)
        per = (n + pad) // self.n_dev
        c = self.local._window_c(per)
        home = self.devices[0]
        partials = []
        self.last_waves = 0
        for d, (dev, eng) in enumerate(zip(self.devices, self.engines)):
            lo, hi = d * per, (d + 1) * per
            pts = pmap(lambda a: a[..., lo:hi].to(dev), points)
            part = eng._msm_fused_many(pts, [s[:, lo:hi].to(dev) for s in scalars], nbits, c)
            self.last_waves += eng.last_waves
            partials.append(pmap(lambda a: a.to(home), part))
        stacked = pmap(lambda *cs: torch.stack(cs, dim=1), *partials)  # (L, n_dev, k)
        return self.ops.sum(stacked, axis=1)


def sharded_msm(ops_for, devices, scalar_bits: int | None = None):
    """fn(points, scalars) -> ProjPoint over a ShardedMSMEngine."""
    eng = ShardedMSMEngine(ops_for, devices, scalar_bits)

    def fn(points, scalars):
        return eng.msm(points, scalars)

    return fn


# --------------------------------------------------------------- NTT


class ShardedNTTEngine:
    """Drop-in for ops.ntt.NTTEngine when the driver holds several devices:
    the four-step decomposition of an n = U*V point transform over a (U, V)
    view of the input.

      1. length-U column transforms, V split over the devices;
      2. the w_n^(+-k1 v) twiddle pass on each device's columns;
      3. an exchange: every device sends every other device the rows that
         device owns (U split over the devices);
      4. length-V row transforms, then the output transpose y[k2*U + k1].

    The sub-transforms are the device's own engine (CUDA kernels
    `ntt_columns` and `mont_mul`), so every value is a canonical residue and
    the result is bit-exact with the local engine; an inverse transform is
    scaled by (1/U)(1/V) = 1/n through the two sub-transforms' own factors.
    coset_shift is elementwise and stays on the first device.  Sizes whose
    sub-transform axes do not cover the devices go to the local engine."""

    def __init__(self, f: Field, host: HostField, devices):
        self.devices = [resolve_device(d) for d in devices]
        self.n_dev = len(self.devices)
        self.f = f
        self.host = host
        self.fields = [get_field(f.p, f.name, d) for d in self.devices]
        self.engines = [ntt_engine(fd, host) for fd in self.fields]
        self.local = ntt_engine(f, host)
        # logn//2 >= log2(n_dev), so both the U and the V axis cover the devices
        self.min_log = 2 * max((self.n_dev - 1).bit_length(), 1)
        self._tw: dict = {}

    def _twiddle_block(self, d: int, logn: int, logu: int, inverse: bool, lo: int, hi: int):
        """(L, U, hi-lo) on device d: w_n^(+-k1 v) for k1 < U, lo <= v < hi."""
        key = (d, logn, inverse)
        if key not in self._tw:
            eng = self.engines[d]
            pt = power_table(eng.f, eng._root(logn, inverse), 1 << logn)
            k1 = np.arange(1 << logu, dtype=np.int64)[:, None]
            v = np.arange(lo, hi, dtype=np.int64)[None, :]
            idx = torch.from_numpy((k1 * v).reshape(-1)).to(pt.device)
            self._tw[key] = pt.index_select(1, idx).reshape(
                eng.f.L, 1 << logu, hi - lo).contiguous()
        return self._tw[key]

    @staticmethod
    def _sub_transform(eng, x, logm: int, inverse: bool):
        """Length-2^logm transform along axis 1 of (L, M, B), with its own
        1/M when inverse."""
        if logm == 0:
            return x
        return eng._fourstep(x.contiguous(), logm, inverse, logm)

    def _transform(self, a, inverse: bool):
        n = a.shape[1]
        logn = n.bit_length() - 1
        assert 1 << logn == n, "size must be a power of two"
        if logn < self.min_log:
            return (self.local.intt if inverse else self.local.ntt)(a)
        L = self.f.L
        logu = logn // 2
        logv = logn - logu
        U, V = 1 << logu, 1 << logv
        vcut, ucut = _bounds(V, self.n_dev), _bounds(U, self.n_dev)
        grid = a.reshape(L, U, V)
        cols = []
        for d, (dev, eng) in enumerate(zip(self.devices, self.engines)):
            lo, hi = vcut[d], vcut[d + 1]
            y = self._sub_transform(eng, grid[:, :, lo:hi].to(dev), logu, inverse)
            cols.append(eng.f.mont_mul(y, self._twiddle_block(d, logn, logu, inverse, lo, hi)))
        home = self.devices[0]
        out = []
        for e, (dev, eng) in enumerate(zip(self.devices, self.engines)):
            lo, hi = ucut[e], ucut[e + 1]
            rows = torch.cat([c[:, lo:hi].to(dev) for c in cols], dim=2)  # (L, Ue, V)
            z = self._sub_transform(eng, rows.transpose(1, 2), logv, inverse)  # (L, V, Ue)
            out.append(z.to(home))
        return torch.cat(out, dim=2).reshape(L, n)

    def ntt(self, a):
        return self._transform(a, False)

    def intt(self, a):
        return self._transform(a, True)

    def coset_shift(self, a, g: int | None = None):
        return self.local.coset_shift(a, g)


@functools.lru_cache(maxsize=None)
def sharded_ntt_engine(f: Field, host: HostField, devices: tuple) -> ShardedNTTEngine:
    """One engine per (field, device tuple): its twiddle blocks are built once."""
    return ShardedNTTEngine(f, host, devices)


def sharded_ntt(f: Field, host: HostField, devices):
    """fn(a) -> forward transform over a ShardedNTTEngine."""
    return sharded_ntt_engine(f, host, tuple(resolve_device(d) for d in devices)).ntt


def sharded_mul_vec(f: Field, devices):
    """fn(a, b): elementwise Montgomery product, the batch axis split over
    the devices; the result lands on the first one."""
    devices = [resolve_device(d) for d in devices]
    fields = [get_field(f.p, f.name, d) for d in devices]

    def fn(a, b):
        cuts = _bounds(a.shape[-1], len(devices))
        parts = [fd.mont_mul(a[..., lo:hi].to(dev), b[..., lo:hi].to(dev)).to(devices[0])
                 for dev, fd, lo, hi in zip(devices, fields, cuts, cuts[1:])]
        return torch.cat(parts, dim=-1)

    return fn


def prover_core_step(curve: CurveParams, devices):
    """The co-Groth16 hot path on one share component, sharded: h = a*b - c
    on each device's part of the constraint axis, then that part's G1 MSM of
    h against its part of the bases (`_msm_fused`), partials summed on the
    first device.  fn(a, b, c, px, py, pz) -> (x, y, z)."""
    devices = [resolve_device(d) for d in devices]
    nbits = curve.fr.p.bit_length()
    fields = [get_field(curve.fr.p, curve.name + ".fr", d) for d in devices]
    engines = [msm_engine(g1_ops(curve, d), scalar_bits=nbits) for d in devices]
    ops = engines[0].ops

    def fn(a_vec, b_vec, c_vec, px, py, pz):
        cuts = _bounds(a_vec.shape[1], len(devices))
        partials = []
        for dev, f, eng, lo, hi in zip(devices, fields, engines, cuts, cuts[1:]):
            if hi == lo:
                continue
            a, b, c = (t[:, lo:hi].to(dev) for t in (a_vec, b_vec, c_vec))
            scal = f.from_mont(f.sub(f.mont_mul(a, b), c))
            pts = ProjPoint(*(t[:, lo:hi].to(dev) for t in (px, py, pz)))
            part = eng._msm_fused(pts, scal, nbits, eng._window_c(hi - lo))
            partials.append(pmap(lambda t: t.to(devices[0]), part))
        res = ops.sum(pmap(lambda *cs: torch.stack(cs, dim=1), *partials), axis=1)
        return res.x, res.y, res.z

    return fn
