"""Pippenger multi-scalar multiplication on torch tensors.

Algorithm (per c-bit signed window):
  1. signed digit recoding (buckets halved: |digit| <= 2^(c-1))
  2. stable sort of the point indices by bucket
  3. conflict-free *wave* accumulation: wave w adds, for every bucket in
     parallel, ranks [w*T, w*T+T) of that bucket's run into a (nw, K+1, T)
     accumulator: one batched point add per wave, no scatter with curve
     semantics anywhere
  4. bucket reduction sum_j j*B_j by two suffix-sum scans
  5. Horner across windows: c doublings + 1 add per window.

The top remainder window has fewer digit bits than the others, so its K+1
bucket lanes are re-packed as S segments of nb lanes (lane = seg*nb + digit,
seg = position block), which keeps its runs as short as the other windows'.

G1 takes the mixed-add path: affine points (sign pre-applied, runs aligned
to T in a permuted table) are added into Jacobian accumulators, one CUDA
kernel a wave (`ec_madd`, which reads each lane's row from the table
itself).  The incomplete formula is made safe by starting every bucket lane
at D = salt*G with the salt drawn from OS entropy per engine; the known
multiple of D is subtracted after Horner, so results do not depend on the
salt.  G2 takes the complete-add path: identity accumulators, the wave's
row gather, and one CUDA kernel per wave (`ec_wave_add_g2`: negate, add,
select).  `_msm_fused`, the form every shard of the device-sharded engines
runs (parallel/sharded.py), takes the complete-add path for G1 too: no salt
and no correction term, and one CUDA kernel per wave that finds each lane's
point from the prepare itself (`ec_wave_add`).  The wave loop is a Python loop; the
number of waves is read from the device once per chunk.  Inputs above
2^CHUNK_LOG points run as chunked prepares and waves into ONE shared
accumulator; reduction and Horner run once at the end.

Share-local over public points, so the same engine serves Plain and REP3.
Each call opens `msm.*` spans (utils/trace.py): `msm.msm` around the call,
and inside it, a chunk at a time, `msm.affine` (the chunk's affine rows,
made once for all the call's scalar vectors; on the complete-add path its
element-major rows, under `msm.table`), then for each vector `msm.prepare`
(digits and sort), `msm.table`, `msm.waves` (the chunk's whole wave loop);
then `msm.reduce`, `msm.horner` and, on the mixed-add path, `msm.correction`.
"""

from __future__ import annotations

import functools
import secrets
import threading

import torch

from ..utils.trace import span
from .curve import (CurveOps, FqLane, ProjPoint, add_wave_lanes, ec_madd, ec_wave_add,
                    ec_wave_add_g2, leaves, pmap)


def _signed_digits(scalar_limbs, nbits: int, c: int):
    """(Ls, N) 32-bit standard-form limbs (int32 bit patterns) -> list of nw
    (N,) int64 signed digits in [-2^(c-1), 2^(c-1)].  The digits are those
    of the integer, whatever limb width carries it."""
    s = scalar_limbs.to(torch.int64) & 0xFFFFFFFF
    pad = torch.cat([s, torch.zeros_like(s[:1])], dim=0)
    nw = -(-(nbits + 1) // c)
    digits = []
    carry = torch.zeros_like(s[0])
    half = 1 << (c - 1)
    full = 1 << c
    top = pad.shape[0] - 1
    for t in range(nw):
        lo = t * c
        i, sh = min(lo // 32, top), lo % 32
        raw = pad[i] >> sh if lo // 32 <= top else torch.zeros_like(carry)
        if sh + c > 32 and i + 1 <= top:
            raw = raw | (pad[i + 1] << (32 - sh))
        raw = raw & (full - 1)
        val = raw + carry
        is_neg = val > half
        # val == full only when raw == full-1 and carry: digit 0, carry 1
        carry = (is_neg | (val == full)).to(torch.int64)
        digits.append(torch.where(is_neg, val - full, val))
    return digits


def _top_window_packing(nbits: int, c: int):
    """(nw, nb, S): window count and the top row's segment packing.

    The top row's digits live in [0, 2^B] with B = nbits - c*(nw-1); they
    are spread over S segments of nb = 2^B + 1 lanes each."""
    nw = -(-(nbits + 1) // c)
    K = 1 << (c - 1)
    B = max(nbits - c * (nw - 1), 0)
    nb = (1 << min(B, c - 1)) + 1
    S = max((K + 1) // nb, 1)
    return nw, nb, S


class MSM:
    # largest single-prepare point count: the sort and the permuted table
    # of one chunk are (nw, 2^CHUNK_LOG)-sized
    CHUNK_LOG = 17
    # default rank-split factor: ranks processed per bucket per wave
    T_DEFAULT = 8

    def __init__(self, ops: CurveOps, c: int | None = None, t: int | None = None,
                 scalar_bits: int | None = None):
        self.ops = ops
        self.c = c
        # actual scalar bit-length (254 for BN254 Fr): the top window's
        # packing is sized from it
        self.scalar_bits = scalar_bits
        self.T = t or self.T_DEFAULT
        self.use_madd = isinstance(ops.lane, FqLane) and ops.gen_host is not None
        self._Daff = None
        self._salt = None
        self._corr: dict = {}
        self._lock = threading.Lock()
        # waves run by the last msm() call (for measurement scripts)
        self.last_waves = 0

    def _window_c(self, n: int) -> int:
        if self.c:
            return self.c
        # never below 4: narrower windows only lengthen Horner (more windows,
        # one add each) while the bucket lanes they save are few anyway
        lg = max(n, 2).bit_length() - 1
        return max(4, min(12, lg - 5))

    # ------------------------------------------------ phase 1: digit/sort

    def _buckets(self, scalar_limbs, nbits: int, c: int):
        """Digits, and the bucket lane of every (window, point): |digit|,
        with the top row packed by segment; digit 0 of the top row goes to
        the dead lane K+1."""
        K = 1 << (c - 1)
        digits = torch.stack(_signed_digits(scalar_limbs, nbits, c))  # (nw, N)
        nw, n = digits.shape
        nw2, nb, S = _top_window_packing(nbits, c)
        assert nw2 == nw
        bucket = digits.abs()
        seg_size = -(-n // S)
        seg = (torch.arange(n, device=digits.device) // seg_size) * nb
        top = bucket[nw - 1]
        bucket[nw - 1] = torch.where(top > 0, top + seg, torch.full_like(top, K + 1))
        return digits, bucket

    def _sorted_runs(self, bucket, K: int):
        """Stable sort by bucket; per-bucket run lengths and run starts over
        all K+2 lanes (lane 0 and lane K+1 are dead)."""
        nw, n = bucket.shape
        sortedb, order = torch.sort(bucket, dim=1, stable=True)
        counts = torch.zeros((nw, K + 2), dtype=torch.int64, device=bucket.device)
        counts.scatter_add_(1, bucket, torch.ones_like(bucket))
        starts = counts.cumsum(dim=1) - counts
        return sortedb, order, counts, starts

    def _prepare(self, scalar_limbs, nbits: int, c: int):
        """Complete-add path: (digits, order, sortedb, bucket_start, n_waves)."""
        K = 1 << (c - 1)
        digits, bucket = self._buckets(scalar_limbs, nbits, c)
        sortedb, order, counts, starts = self._sorted_runs(bucket, K)
        n_waves = counts[:, 1: K + 1].max()
        return digits, order, sortedb, starts[:, : K + 1].contiguous(), n_waves

    def _prepare_madd(self, scalar_limbs, nbits: int, c: int):
        """Mixed-add path: digit/sort plus a run-ALIGNED permuted-table
        layout.  Every live bucket's sorted run is padded to a multiple of
        T in the table, so wave w reads ONE block of T rows per bucket.

        Returns (scatter_idx, astart, aend, n_waves):
          scatter_idx (nw, M_tab): signed row index per aligned slot (row i
            is point i, row n+i its negation; 0 for padding slots, which
            `aend` masks);
          astart/aend (nw, K+1): aligned run start / logical run end;
          M_tab = ceil(n/T)*T + (K+1)*T is static given (n, c).
        Positions that are not accumulated (digit 0, the top row's dead
        lane) are sent to one slot past the whole table and dropped."""
        T = self.T
        K = 1 << (c - 1)
        digits, bucket = self._buckets(scalar_limbs, nbits, c)
        nw, n = digits.shape
        sortedb, order, counts, starts = self._sorted_runs(bucket, K)
        sdig = digits.gather(1, order)
        live = (sortedb > 0) & (sortedb <= K)

        lens = counts[:, : K + 1].clone()
        lens[:, 0] = 0  # bucket 0 is never accumulated
        n_waves = lens.max()
        alens = -(-lens // T) * T
        astart = alens.cumsum(dim=1) - alens
        aend = astart + lens

        pos = torch.arange(n, device=digits.device).expand(nw, n)
        rank = pos - starts.gather(1, sortedb)
        M_tab = -(-n // T) * T + (K + 1) * T
        dead = nw * M_tab
        woff = (torch.arange(nw, device=digits.device) * M_tab)[:, None]
        apos = astart.gather(1, sortedb.clamp(max=K)) + rank + woff
        apos = torch.where(live, apos, torch.full_like(apos, dead))
        sidx = order + torch.where(sdig < 0, n, 0)
        scatter_idx = torch.zeros(dead + 1, dtype=torch.int64, device=digits.device)
        scatter_idx[apos.reshape(-1)] = sidx.reshape(-1)
        return scatter_idx[:dead].reshape(nw, M_tab), astart, aend, n_waves

    def _table_rows(self, pts_em2, scatter_idx):
        """(nw, M_tab) slot indices -> the (nw*M_tab, rw) run-aligned table."""
        return pts_em2.index_select(0, scatter_idx.reshape(-1))

    def _emajor(self, points: ProjPoint):
        """(L, N) coordinate tensors -> (N, n_leaves*L) element-major copy."""
        return torch.cat(leaves(points), dim=0).t().contiguous()

    # ------------------------------------------------ phase 2: one wave

    def _wave_step(self, pts_em, digits, order, sortedb, bucket_start, w, acc):
        """Wave w of the complete-add path: add ranks [w*T, w*T+T) of every
        bucket's run into the (nw, K+1, T) accumulator.  G1: one kernel,
        which finds each lane's point itself (`ec_wave_add`).  G2: the
        wave's gathers here (`add_wave_lanes`), then one kernel for the
        negation, the add and the select."""
        ops = self.ops
        if isinstance(ops.lane, FqLane):
            return ec_wave_add(ops, acc, pts_em, order, sortedb, digits, bucket_start, w)
        src, neg, valid = add_wave_lanes(order, sortedb, digits, bucket_start, w, self.T)
        rows = pts_em.index_select(0, src)  # (nw*Kp1*T, n_leaves*L)
        return ec_wave_add_g2(ops, acc, rows, neg, valid)

    # ------------------------------------------- phase 2': mixed-add waves

    @property
    def _INIT_SALT(self) -> int:
        if self._salt is None:
            self._salt = secrets.randbits(253) | (1 << 252)
        return self._salt

    def _int_limbs32(self, v: int):
        out = []
        while v:
            out.append(v & 0xFFFFFFFF)
            v >>= 32
        dev = self.ops.lane.f.device
        return torch.tensor(out or [0], dtype=torch.int64, device=dev).to(torch.int32)

    def _init_affine(self):
        """(Dx, Dy) Montgomery limbs (L,) of the bucket-init point D."""
        with self._lock:
            if self._Daff is None:
                ops = self.ops
                g = ops.encode_points([ops.gen_host])
                eb = self._int_limbs32(self._INIT_SALT)
                D = ops.scalar_mul(g, eb[:, None], nbits=self._INIT_SALT.bit_length())
                ax, ay = ops.to_affine_limbs(D)
                self._Daff = (ax[:, 0].contiguous(), ay[:, 0].contiguous())
        return self._Daff

    def _affine_em(self, points: ProjPoint):
        """Element-major affine rows (identity -> (0,0)), positive AND
        negated-y variants stacked: (2N, 2L) int32.  Row i is point i; row
        N+i is point i with y -> p-y (identity y=0 stays 0)."""
        ax, ay0 = self.ops.to_affine_limbs(points)
        ayn = self.ops.lane.f.neg(ay0)
        ax = torch.cat([ax, ax], dim=1)
        ay = torch.cat([ay0, ayn], dim=1)
        return torch.cat([ax, ay], dim=0).t().contiguous()

    def _wave_step_madd(self, table, astart, aend, w, acc):
        """One mixed-add wave against the run-ALIGNED signed table: one
        kernel, which reads each valid lane's row itself (`ec_madd`)."""
        return ec_madd(self.ops.lane.f, acc, table, astart, aend, w)

    def _jac_to_homog(self, acc: ProjPoint) -> ProjPoint:
        """Jacobian (X, Y, Z) -> homogeneous (X*Z, Y, Z^3) for the
        complete-formula reduction phases."""
        f = self.ops.lane.f
        z2 = f.mont_mul(acc.z, acc.z)
        return ProjPoint(f.mont_mul(acc.x, acc.z), acc.y, f.mont_mul(z2, acc.z))

    def _madd_correction(self, nbits: int, c: int) -> ProjPoint:
        """E*D where E totals the D-inits that survive into the reduction."""
        key = (nbits, c)
        Dx, Dy = self._init_affine()
        with self._lock:
            if key in self._corr:
                return self._corr[key]
            nw, nb, S = _top_window_packing(nbits, c)
            K = 1 << (c - 1)
            w_full = K * (K + 1) // 2
            w_top = S * nb * (nb - 1) // 2 if nb != K + 1 else w_full
            E = self.T * sum(
                (1 << (c * w)) * (w_top if w == nw - 1 else w_full)
                for w in range(nw)
            )
            D = ProjPoint(Dx, Dy, self.ops.lane.one(()).contiguous())
            eb = self._int_limbs32(E)
            self._corr[key] = self.ops.scalar_mul(D, eb, nbits=E.bit_length())
            return self._corr[key]

    # ------------------------------------------------ phase 3: reduction

    def _reduce(self, acc, nb: int, S: int):
        """(nw, K+1, T, *rest) bucket accumulators -> per-window sums
        sum_j w_j*B_j of shape (nw, *rest).

        Full rows use weight = lane; the packed top row uses
        weight = lane mod nb per segment, then sums its S segments."""
        ops = self.ops
        acc = ops.sum(acc, axis=3)  # fold the T rank-split partials
        Kp1 = leaves(acc)[0].shape[2]

        # when the top window has full digit support (nb == K+1) it is an
        # ordinary row and reduces with the rest; otherwise it is packed
        full = acc if nb == Kp1 else pmap(lambda a: a[:, :-1], acc)
        tail = pmap(lambda a: a[:, :, 1:], full)
        suffix2 = ops.suffix_sums(ops.suffix_sums(tail, axis=2), axis=2)
        wsums = pmap(lambda a: a[:, :, 0], suffix2)

        if nb == Kp1:
            return wsums
        top = pmap(lambda a: a[:, -1, : S * nb].reshape(
            (a.shape[0], S, nb) + tuple(a.shape[3:])), acc)
        ttail = pmap(lambda a: a[:, :, 1:], top)  # (L, S, nb-1)
        ts = ops.suffix_sums(ops.suffix_sums(ttail, axis=2), axis=2)
        tsum = ops.sum(pmap(lambda a: a[:, :, 0], ts), axis=1)
        return pmap(lambda a, t: torch.cat([a, t[:, None]], dim=1), wsums, tsum)

    # ------------------------------------------------ phase 4: Horner

    def _horner(self, wsums, c: int):
        ops = self.ops
        first = leaves(wsums)[0]
        nw = first.shape[1]
        result = ops.identity(tuple(first.shape[2:]))
        for w in range(nw - 1, -1, -1):
            for _ in range(c):
                result = ops.double(result)
            result = ops.add(result, pmap(lambda a: a[:, w].contiguous(), wsums))
        return result

    # ------------------------------------------------ driver

    def msm(self, points: ProjPoint, scalar_limbs, nbits: int | None = None) -> ProjPoint:
        """points: batched ProjPoint (coords (L, N)); scalars (Ls, N) 32-bit
        standard-form limbs.  Returns a single ProjPoint."""
        res = self.msm_many(points, [scalar_limbs], nbits)
        return pmap(lambda c: c[..., 0], res)

    def msm_many(self, points: ProjPoint, scalars: list, nbits: int | None = None) -> ProjPoint:
        """k MSMs over the same points (e.g. the two components of a REP3
        share): the waves run per scalar vector, bucket reduction and Horner
        run ONCE over a trailing axis of k.  Returns a ProjPoint of batch (k,)."""
        k = len(scalars)
        n = scalars[0].shape[1]
        if n == 0:
            return self.ops.identity((k,))
        nbits = nbits or self.scalar_bits or 32 * scalars[0].shape[0]
        c = self._window_c(min(n, 1 << self.CHUNK_LOG))
        res = self._msm_windows(points, scalars, nbits, c, self.use_madd)
        if self.use_madd:
            with span("msm.correction"):
                res = self.ops.add(res, self.ops.neg(self._madd_correction(nbits, c)))
        return res

    def _msm_fused(self, points: ProjPoint, scalar_limbs, nbits: int, c: int) -> ProjPoint:
        """One MSM on the complete-add path with window width c, whatever
        the group: identity accumulators, the wave loop (`ec_wave_add` for
        G1), bucket reduction, Horner.  What a shard of the device-sharded
        engines runs; c comes from the shard's own point count."""
        res = self._msm_fused_many(points, [scalar_limbs], nbits, c)
        return pmap(lambda a: a[..., 0], res)

    def _msm_fused_many(self, points: ProjPoint, scalars: list, nbits: int, c: int) -> ProjPoint:
        """`_msm_fused` for k scalar vectors over the same points; batch (k,)."""
        return self._msm_windows(points, scalars, nbits, c, madd=False)

    def _msm_windows(self, points, scalars, nbits: int, c: int, madd: bool) -> ProjPoint:
        """Waves per scalar vector, then one bucket reduction and one Horner
        over a trailing axis of len(scalars).  On the mixed-add path the
        result still carries the bucket-init points (see `msm_many`)."""
        _, nb, S = _top_window_packing(nbits, c)
        self.last_waves = 0
        with span("msm.msm"):
            accs = self._accumulate(points, scalars, nbits, c, madd)
            acc = pmap(lambda *cs: torch.stack(cs, dim=-1), *accs)
            with span("msm.reduce"):
                wsums = self._reduce(acc, nb, S)
            with span("msm.horner"):
                return self._horner(wsums, c)

    def _accumulate(self, points: ProjPoint, scalars: list, nbits: int, c: int,
                    madd: bool) -> list:
        """All waves of each scalar vector over the same points: a (nw, K+1,
        T) bucket accumulator a vector, in homogeneous coordinates.  A
        chunk's point rows (affine or element-major) are made once for all
        the vectors."""
        n = scalars[0].shape[1]
        chunk = 1 << self.CHUNK_LOG
        K = 1 << (c - 1)
        nw = -(-(nbits + 1) // c)
        T = self.T
        ln = self.ops.lane
        shape = (nw, K + 1, T)
        if madd:
            Dx, Dy = self._init_affine()
            accs = [ProjPoint(
                ln.broadcast_to(Dx[:, None, None, None], shape).contiguous(),
                ln.broadcast_to(Dy[:, None, None, None], shape).contiguous(),
                ln.one(shape).contiguous(),
            ) for _ in scalars]
        else:
            accs = [self.ops.identity(shape) for _ in scalars]
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            pts = pmap(lambda a: a[..., lo:hi], points)
            if madd:
                with span("msm.affine"):
                    pts_em2 = self._affine_em(pts)
            else:
                with span("msm.table"):
                    pts_em = self._emajor(pts)
            for i, s in enumerate(scalars):
                sl = s[:, lo:hi]
                acc = accs[i]
                if madd:
                    with span("msm.prepare"):
                        scatter_idx, astart, aend, n_waves = self._prepare_madd(sl, nbits, c)
                    with span("msm.table"):
                        table = self._table_rows(pts_em2, scatter_idx)
                    with span("msm.waves"):
                        n_super = -(-int(n_waves.item()) // T)
                        for w in range(n_super):
                            acc = self._wave_step_madd(table, astart, aend, w, acc)
                    del table
                else:
                    with span("msm.prepare"):
                        digits, order, sortedb, bucket_start, n_waves = self._prepare(sl, nbits, c)
                    with span("msm.waves"):
                        n_super = -(-int(n_waves.item()) // T)
                        for w in range(n_super):
                            acc = self._wave_step(pts_em, digits, order, sortedb,
                                                  bucket_start, w, acc)
                accs[i] = acc
                self.last_waves += n_super
        return [self._jac_to_homog(a) for a in accs] if madd else accs


@functools.lru_cache(maxsize=None)
def msm_engine(ops: CurveOps, c: int | None = None, t: int | None = None,
               scalar_bits: int | None = None) -> MSM:
    """One engine per (curve ops, window, rank split): its bucket-init salt
    is drawn once per process."""
    return MSM(ops, c, t, scalar_bits)
