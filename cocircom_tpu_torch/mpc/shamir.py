"""Shamir secret sharing (n parties, threshold t) over torch limb tensors.

  * share = f(id+1) for a degree-t polynomial with the secret at f(0)
  * open  = broadcast_next(t+1) + Lagrange at 0
  * mul   = local product (degree 2t), then a king-based degree reduction
    masked by a preprocessed double share (r_t, r_2t): the parties send
    x + r_2t to the king, the king reshares the value at degree t, the
    parties subtract r_t.
  * preprocessing: dealerless Vandermonde batch extraction (DN07): every
    party deals one random double sharing per slot, and the rows [x^k] of
    the Vandermonde matrix over the n received share columns give t+1
    independent pairs a slot.
  * MSM/FFT are share-local (linearity), one component.

Every party's randomness is one ChaCha12 stream (domain 4) drawn in a fixed
order, so pinned seeds give the JAX package's shares.  Requires n >= 2t+1.
"""

from __future__ import annotations

import torch

from ..fields.params import CurveParams, HostField
from ..ops.curve import CurveOps, ProjPoint, pmap
from ..ops.field import Field, get_field, resolve_device
from .driver import Driver, as_index, inverse, scalar_mul_many, segment_sum_mont
from .net import Network


def _lagrange_at_zero(host: HostField, xs: list[int]) -> list[int]:
    """Lagrange coefficients for interpolating f(0) from points xs."""
    out = []
    for j, xj in enumerate(xs):
        num, den = 1, 1
        for m, xm in enumerate(xs):
            if m != j:
                num = num * xm % host.p
                den = den * (xm - xj) % host.p
        out.append(num * host.inv(den) % host.p)
    return out


def _times_const(f: Field, c, v: int):
    """c * v for a host int v (Montgomery constant, broadcast).  Callers
    only read the result, so v = 1 (party 1's powers, the DN07 rows' x^0)
    returns c itself: the same residues without a multiply."""
    if v % f.p == 1:
        return c
    return f.mont_mul(c, f._bc(f.const_mont(v % f.p), c))


def _eval_poly_shares(f: Field, secret_mont, coeffs, xs: list[int]):
    """shares_j = secret + sum_k coeffs[k] * x_j^(k+1) for each x in xs.
    secret (L, *batch); coeffs list of (L, *batch); returns one per x."""
    shares = []
    for x in xs:
        acc = secret_mont
        xp = 1
        for c in coeffs:
            xp = xp * x
            acc = f.add(acc, _times_const(f, c, xp))
        shares.append(acc)
    return shares


def _lincomb(f: Field, shares: list, lams):
    """sum lam_j * share_j with host-int lams given in v*R form.  The list
    is emptied as it goes, so a share nothing else holds is freed once
    used."""
    acc = None
    for lam in lams:
        s = shares.pop(0)
        term = f.mont_mul(s, f._bc(f._const(lam), s))
        del s
        acc = term if acc is None else f.add(acc, term)
    return acc


def share_field_vec_shamir(f: Field, vec_mont, threshold: int, n_parties: int,
                           seed: bytes | int | None = None, device=None):
    """Dealer-side split: one (L, N) share tensor per party, on `device`
    (the card unless the caller names another).  Mask entropy: a 256-bit
    ChaCha key (fresh OS entropy unless a test seed is passed, which is
    SHA-256 expanded)."""
    from ..utils.chacha import ChaChaStream, fresh_seed

    device = resolve_device(device)
    f = get_field(f.p, f.name, device)
    vec_mont = vec_mont.to(device)
    stream = ChaChaStream(fresh_seed() if seed is None else seed, domain=3, device=device)
    batch = vec_mont.shape[1:]
    coeffs = [stream.rand_mont(f, batch) for _ in range(threshold)]
    return _eval_poly_shares(f, vec_mont, coeffs, list(range(1, n_parties + 1)))


def combine_field_shares_shamir(f: Field, shares: list, threshold: int):
    xs = list(range(1, threshold + 2))
    lams = [lam * f.R % f.p for lam in _lagrange_at_zero(f.host, xs)]
    return _lincomb(f, shares[: threshold + 1], lams)


class ShamirDriver(Driver):
    protocol = "shamir"
    KING = 0

    def __init__(self, curve: CurveParams, net: Network, threshold: int = 1,
                 device=None, devices=None):
        super().__init__(curve, device=device, devices=devices)
        if net.n_parties < 2 * threshold + 1:
            raise ValueError("Shamir needs n >= 2t+1 parties")
        self.net = net
        self.id = net.id
        self.t = threshold
        self.n = net.n_parties
        from ..utils.chacha import ChaChaStream, fresh_seed

        self._stream = ChaChaStream(fresh_seed(), domain=4, device=self.device)
        self._pairs = None  # the unused (r_t, r_2t) pairs, two (L, k) tensors
        fr, host = self.fr, curve.fr
        # Lagrange for open (parties id, id-1, ..., id-t)
        own_xs = [((self.id - k) % self.n) + 1 for k in range(self.t + 1)]
        self._open_lams = [lam * fr.R % fr.p for lam in _lagrange_at_zero(host, own_xs)]
        # Lagrange for the king's reconstruction at degree 2t
        all_xs = list(range(1, self.n + 1))
        self._king_lams = [lam * fr.R % fr.p
                           for lam in _lagrange_at_zero(host, all_xs[: 2 * self.t + 1])]

    def _recv(self, frm: int):
        return pmap(lambda t: t.to(self.device), self.net.recv(frm))

    # ------------------------------------------------------- rng helpers

    def _rand(self, shape=()):
        return self._stream.rand_mont(self.fr, shape)

    def _deal(self, secret_mont, degree: int):
        """Deal a degree-d sharing of secret to all parties; returns our own
        share and sends the others theirs (in party order)."""
        batch = secret_mont.shape[1:]
        coeffs = [self._rand(batch) for _ in range(degree)]
        shares = _eval_poly_shares(self.fr, secret_mont, coeffs, list(range(1, self.n + 1)))
        del coeffs
        for p in range(self.n):
            if p != self.id:
                self.net.send(p, shares[p])
        return shares[self.id]

    def preprocess(self, amount: int):
        """Random double shares (r_t, r_2t) for at least `amount` more
        products, kept after any left from before."""
        self._generate(-(-amount // (self.t + 1)), 0, None)

    def _generate(self, slots: int, take: int, y):
        """Make (t+1) * slots random double shares without a dealer: every
        party deals ONE random double sharing a slot, and the Vandermonde
        rows [x^k]_{k<=t} over the n received share columns give t+1
        independent pairs a slot (DN07).  The pairs of row k follow those of
        row k-1, after any left from before.  The first `take` are taken:
        returns their r_t and, unless `y` is given, their r_2t; with `y`
        ((L, take)) their r_2t are added into it in place instead of being
        stored.  The rest are kept.

        Each column is folded into the rows as it arrives and then dropped,
        and the 2t sharing is dealt only once the t columns are in: what a
        party deals to the others waits in their queues, and at 2^27
        products a column is 2 GiB."""
        fr, L = self.fr, self.fr.L
        old = self._pairs
        self._pairs = None
        have = 0 if old is None else old[0].shape[1]
        total = have + (self.t + 1) * slots

        def buffer(width, first=None):
            buf = torch.empty((L, width), dtype=torch.int32, device=self.device)
            if first is not None:
                buf[:, :have] = first
            return buf

        rt = buffer(total, None if old is None else old[0])
        if y is None:
            r2t = buffer(total, None if old is None else old[1])
        else:
            if old is not None:
                fr.add(y[:, :have], old[1], out=y[:, :have])
            tail = buffer(total - take)   # the r_2t kept for later
        del old

        def targets(deg, k):
            """(destination, first and last column of the dealt column,
            whether the destination starts empty) for row k of degree deg."""
            lo, hi = have + k * slots, have + (k + 1) * slots
            if deg == 0 or y is None:
                return [((rt if deg == 0 else r2t)[:, lo:hi], 0, slots, True)]
            out = []
            if lo < take:
                out.append((y[:, lo:min(hi, take)], 0, min(hi, take) - lo, False))
            if hi > take:
                out.append((tail[:, max(lo, take) - take: hi - take], max(lo, take) - lo, slots,
                            True))
            return out

        def fold(deg, i, col, first):
            for k in range(self.t + 1):
                for dst, c0, c1, empty in targets(deg, k):
                    term = _times_const(fr, col[:, c0:c1], pow(i + 1, k, fr.p))
                    if empty and first:
                        dst.copy_(term)
                    else:
                        fr.add(dst, term, out=dst)

        contrib = self._rand((slots,))
        for deg, degree in enumerate((self.t, 2 * self.t)):
            fold(deg, self.id, self._deal(contrib, degree), True)
            for p in range(self.n):
                if p != self.id:
                    fold(deg, p, self._recv(p), False)
        del contrib
        if take == 0:
            self._pairs = (rt, r2t)
            return None, None
        kept = tail if y is not None else r2t[:, take:].clone()
        if total > take:  # copies, so the taken pairs can be freed
            self._pairs = (rt[:, take:].clone(), kept)
        return rt[:, :take], (None if y is not None else r2t[:, :take])

    def _take_pairs(self, amount: int, y=None):
        """The next `amount` double shares: (r_t, r_2t), or with `y`
        ((L, amount)) (r_t, None) and y += r_2t in place."""
        have = 0 if self._pairs is None else self._pairs[0].shape[1]
        if have < amount:
            return self._generate(-(-(amount - have) // (self.t + 1)), amount, y)
        rt, r2t = self._pairs
        self._pairs = None
        if have > amount:
            self._pairs = (rt[:, amount:].clone(), r2t[:, amount:].clone())
        rt, r2t = rt[:, :amount], r2t[:, :amount]
        if y is None:
            return rt, r2t
        self.fr.add(y, r2t, out=y)
        return rt, None

    # ------------------------------------------------------- share algebra

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

    def degree_reduce(self, x2t):
        """Masked king-based reduction of a whole vector: 2 rounds.  x2t is
        masked in place (y = x + r_2t), so no copy of a product of 2^27
        elements is made: the caller hands it over."""
        shape = x2t.shape
        y = x2t.reshape(self.fr.L, -1)
        del x2t
        rt, _ = self._take_pairs(y.shape[1], y)
        if self.id == self.KING:
            shares = [y] + [self._recv(p) for p in range(1, self.n)][: 2 * self.t]
            del y
            val = _lincomb(self.fr, shares, self._king_lams)
            own = self._deal(val, self.t)
            del val
        else:
            self.net.send(self.KING, y)
            del y
            own = self._recv(self.KING)
        return self.fr.sub(own, rt).reshape(shape)

    def mul_vec(self, a, b):
        prod = [self.fr.mont_mul(a, b)]
        del a, b  # the operands may be the largest tensors alive
        return self.degree_reduce(prod.pop())  # handed over: masked in place

    mul = mul_vec

    def rand(self, shape=()):
        n = 1
        for s in shape:
            n *= s
        rt, _ = self._take_pairs(n)
        return rt.reshape((self.fr.L,) + tuple(shape))

    def open_many(self, x):
        got = self.net.broadcast_next(x, self.t + 1)
        return _lincomb(self.fr, [g.to(self.device) for g in got], self._open_lams)

    open = open_many

    def mul_open_many(self, a, b):
        return self.open_many(self.mul_vec(a, b))

    def inv_many(self, x):
        """Masked-open inversion; aborts on zero denominators (the opened
        r*x reveals zero-ness by construction; the upstream protocol errors
        too)."""
        r = self.rand(x.shape[1:])
        opened = self.open_many(self.mul_vec(r, x))
        if not bool(opened.any(dim=0).all()):
            raise ZeroDivisionError("MPC inversion of a zero share")
        return self.mul_public(r, inverse(self.fr, opened))

    def inv_many_guarded(self, x):
        """Like inv_many but maps 0 -> 0 instead of aborting: the VM's
        guarded division (see Rep3Driver.inv_many_guarded)."""
        r = self.rand(x.shape[1:])
        opened = self.open_many(self.mul_vec(r, x))
        return self.mul_public(r, inverse(self.fr, opened))

    def gather(self, x, idx):
        return x.index_select(1, as_index(idx, x.device))

    def concat(self, *vecs):
        return torch.cat(vecs, dim=1)

    slice = Driver.slice_share

    def set_slice(self, x, lo, values):
        out = x.clone()
        out[:, lo: lo + values.shape[1]] = values
        return out

    def segment_sum(self, values, seg_ids, num_segments):
        return segment_sum_mont(self.fr, values, as_index(seg_ids, values.device),
                                num_segments)

    # ------------------------------------------------------------- FFT

    def fft(self, a):
        return self.ntt.ntt(a)

    def ifft(self, a):
        return self.ntt.intt(a)

    def coset_shift(self, a, g=None):
        return self.ntt.coset_shift(a, g)

    # ------------------------------------------------------------- EC

    def to_scalars(self, x):
        return self.fr.from_mont(x)

    def msm_g1(self, points: ProjPoint, share_vec):
        return self.msm_g1_engine.msm(points, self.to_scalars(share_vec))

    def msm_g2(self, points, share_vec):
        return self.msm_g2_engine.msm(points, self.to_scalars(share_vec))

    def _smul_many(self, ops: CurveOps, points: list, scalars: list) -> list:
        """points[i] * scalars[i] (standard-form limbs) as one batched
        double-and-add; a single scalar against a batched point is applied
        to every point of the batch."""
        batch = tuple(ops.lane.batch_shape(points[0].x))
        scalars = [s.reshape((-1,) + (1,) * len(batch)).expand((s.shape[0],) + batch)
                   if s.dim() == 1 and batch else s for s in scalars]
        return scalar_mul_many(ops, points, scalars)

    def scalar_mul_public_point(self, ops: CurveOps, point: ProjPoint, share):
        return self._smul_many(ops, [point], [self.fr.from_mont(share)])[0]

    def _point_lincomb(self, ops: CurveOps, points: list, lams):
        """sum lam_j * P_j with host-int lams given in v*R form."""
        fr = self.fr
        rinv = pow(fr.R, -1, fr.p)
        limbs = fr.to_limbs([lam * rinv % fr.p for lam in lams])
        terms = self._smul_many(ops, points, [limbs[:, j] for j in range(len(lams))])
        acc = terms[0]
        for term in terms[1:]:
            acc = ops.add(acc, term)
        return acc

    def _generator(self, ops: CurveOps) -> ProjPoint:
        gen = ops.encode_points([self.curve.g1_gen if ops is self.g1 else self.curve.g2_gen])
        return pmap(lambda c: c[..., 0], gen)

    def degree_reduce_point(self, ops: CurveOps, x2t: ProjPoint):
        """The king's reduction for a degree-2t point, masked by r_2t G."""
        fr = self.fr
        rt, r2t = self._take_pairs(1)
        gen = self._generator(ops)
        r2t_pt, rt_pt = self._smul_many(ops, [gen, gen],
                                        [fr.from_mont(r2t[:, 0]), fr.from_mont(rt[:, 0])])
        y = ops.add(x2t, r2t_pt)
        if self.id == self.KING:
            pts = [y] + [ProjPoint(*self._recv(p)) for p in range(1, self.n)]
            val = self._point_lincomb(ops, pts[: 2 * self.t + 1], self._king_lams)
            # a degree-t sharing of the point: P + sum_k c_k x^k G, the n*t
            # products c_k x^k G as one batch
            coeffs = [self._rand(()) for _ in range(self.t)]
            cs = [fr.from_mont(_times_const(fr, c, (pid + 1) ** (k + 1)))
                  for pid in range(self.n) for k, c in enumerate(coeffs)]
            terms = self._smul_many(ops, [gen] * len(cs), cs) if cs else []
            own = None
            for pid in range(self.n):
                acc = val
                for term in terms[pid * self.t: (pid + 1) * self.t]:
                    acc = ops.add(acc, term)
                if pid == self.id:
                    own = acc
                else:
                    self.net.send(pid, acc)
        else:
            self.net.send(self.KING, y)
            own = ProjPoint(*self._recv(self.KING))
        return ops.add(own, ops.neg(rt_pt))

    def scalar_mul(self, ops: CurveOps, pt: ProjPoint, s):
        """Shared point x shared scalar -> degree-2t point, then reduce."""
        return self.degree_reduce_point(ops, self.scalar_mul_public_point(ops, pt, s))

    def point_add(self, ops: CurveOps, a, b):
        return ops.add(a, b)

    def point_add_public(self, ops: CurveOps, a, p):
        return ops.add(a, p)

    def point_sub(self, ops, a, b):
        return ops.add(a, ops.neg(b))

    def open_point(self, ops: CurveOps, x: ProjPoint):
        got = self.net.broadcast_next(x, self.t + 1)
        pts = [ProjPoint(*pmap(lambda t: t.to(self.device), g)) for g in got]
        return self._point_lincomb(ops, pts, self._open_lams)

    def open_two_points(self, x: ProjPoint, y: ProjPoint):
        got = self.net.broadcast_next((x, y), self.t + 1)
        got = [pmap(lambda t: t.to(self.device), g) for g in got]
        return (self._point_lincomb(self.g1, [ProjPoint(*g[0]) for g in got], self._open_lams),
                self._point_lincomb(self.g2, [ProjPoint(*g[1]) for g in got], self._open_lams))
