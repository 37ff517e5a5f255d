"""Collaborative PLONK prover (snarkjs-compatible), generic over the MPC driver.

Parity: co-circom/co-plonk/src/{round1..round5}.rs, the five-round state
machine:
  round1: wire polys + blinding, 3 commitments              (1 open round)
  round2: permutation poly z via constant-round prefix products
          (Ozdemir-Boneh masking), 1 commitment             (~6 rounds)
  round3: quotient t on the 4n coset: every product batched into wide
          single-round mul_vec calls; Z_H division local    (3 mul rounds)
  round4: 4 shared evaluations opened in one round
  round5: linearization r, W_xi, W_xiw: local; 2 commitments opened
All Fiat-Shamir challenges ride the byte-exact Keccak256 transcript
(ops/keccak.py).  Public vectors stay on the driver's device; a public
constant is one (L, 1) column that broadcasts.  Each round is a tracer span
("round 1" .. "round 5"), and each is a method of its own, so its
temporaries are freed when it returns: round 3 at 2^20 gates multiplies 32
vectors of 2^22 elements in one round.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from ..io.plonk_zkey import PlonkZKey
from ..ops.curve import leaves, pmap
from ..ops.keccak import Keccak256Transcript
from ..ops.ntt import power_table
from .groth16 import SharedWitness

ROUND_SPANS = tuple(f"round {k}" for k in range(1, 6))


def _pad_share(x, length: int):
    """A share's columns cut or zero-padded to `length`."""
    def fit(c):
        cur = c.shape[1]
        if cur >= length:
            return c[:, :length]
        return torch.cat([c, torch.zeros((c.shape[0], length - cur), dtype=c.dtype,
                                         device=c.device)], dim=1)
    return pmap(fit, x)


def _mul_owned(d, operands: list):
    """d.mul_vec of the two operands in `operands`, which is emptied as they
    are handed over: the driver then holds the only references and frees
    them once the product is formed (round 3's operands are the largest
    tensors of the proof)."""
    return d.mul_vec(operands.pop(0), operands.pop(0))


class CoPlonk:
    def __init__(self, driver, deterministic_blinding: bool = False, tracer=None):
        from ..utils.trace import tracer_or_null

        if deterministic_blinding and not os.environ.get("COCIRCOM_INSECURE_DETERMINISTIC"):
            raise PermissionError(
                "deterministic_blinding replaces the 11 PLONK blinding "
                "scalars with public constants and destroys zero-knowledge; "
                "it exists only for round-KAT tests. Set "
                "COCIRCOM_INSECURE_DETERMINISTIC=1 to acknowledge.")
        self.d = driver
        self.deterministic = deterministic_blinding
        self.tracer = tracer_or_null(tracer)

    # ------------------------------------------------------------- helpers

    def _c(self, v: int):
        """Montgomery constant v as an (L, 1) column."""
        fr = self.d.fr
        return fr.const_mont(v % fr.p)[:, None]

    def _at0(self, v: int, length: int):
        """The public vector (v, 0, ..., 0) of `length` elements."""
        t = self.d.fr.zeros((length,)).clone()
        t[:, 0] = self.d.fr.const_mont(v % self.d.fr.p)
        return t

    def _commit_open(self, st, polys: list) -> list:
        """Commit to each polynomial (one MSM call for all, the shorter ones
        padded with zero coefficients), open the commitments in one round
        and decode them to host affine points."""
        d = self.d
        n = max(leaves(p)[0].shape[1] for p in polys)
        commits = d.msm_g1_many(pmap(lambda c: c[..., :n], st.p_tau),
                                [_pad_share(p, n) for p in polys])
        return d.g1.decode_points(d.open_point(d.g1, d.stack_points(commits)))

    def _blind(self, poly_share, bs: list):
        """poly - sum_k rev(bs)[k] X^k + X^n * (rev(bs) poly); parity:
        plonk_utils::blind_coefficients (lib.rs:140-158)."""
        d = self.d
        rev = d.stack_shares(list(reversed(bs)))
        n = leaves(poly_share)[0].shape[1]
        k = len(bs)
        head = d.sub(d.slice_share(poly_share, 0, k), rev)
        return d.concat_shares(head, d.slice_share(poly_share, k, n), rev)

    def _fft4(self, st, poly_share):
        """Evaluate (unblinded) coefficients on the 4n extended domain."""
        return self.d.fft(_pad_share(poly_share, 4 * st.n))

    # ------------------------------------------------------------- witness

    def _build_witness(self, zk: PlonkZKey, shared: SharedWitness):
        """Returns (publics ints, the gather source W).

        Layout of W (share vec, length n_vars):
          [0..n_public]                     promoted publics (index 0 -> 0)
          (n_public..n_vars-n_additions)    the shared witness
          [n_vars-n_additions..n_vars)      addition results (computed here)
        Additions may read earlier additions: they are computed a level of
        the dependency order at a time, then put in their places.
        Parity: round1.rs calculate_additions + lib.rs get_witness.
        """
        d = self.d
        # wire 0 is promoted as ZERO (the snarkjs layout); the returned
        # publics are the bare nPublic values the transcript consumes
        publics = [int(x) for x in shared.public_inputs[1:]]
        base = d.concat(d.promote_public(d.encode_publics([0] + publics)), shared.witness)
        n_base = zk.n_vars - zk.n_additions
        if zk.n_additions == 0:
            return publics, base
        id1, id2 = zk.add_id1, zk.add_id2
        level = np.zeros(zk.n_additions, np.int64)
        for i in range(zk.n_additions):
            for ref in (id1[i], id2[i]):
                if ref >= n_base:
                    level[i] = max(level[i], level[ref - n_base] + 1)
        pos = np.arange(zk.n_vars, dtype=np.int64)   # place of a wire in `src`
        src, done = base, 0
        for lv in range(int(level.max()) + 1):
            ids = np.nonzero(level == lv)[0]
            cols = torch.from_numpy(ids).to(zk.add_f1.device)
            adds = d.add(d.mul_public(d.gather(src, pos[id1[ids]]), zk.add_f1[:, cols]),
                         d.mul_public(d.gather(src, pos[id2[ids]]), zk.add_f2[:, cols]))
            pos[n_base + ids] = n_base + done + np.arange(len(ids))
            done += len(ids)
            src = d.concat(src, adds)
        if int(level.max()) == 0:
            return publics, src
        return publics, d.gather(src, pos)

    # ------------------------------------------------------------- rounds

    def prove(self, zk: PlonkZKey, shared: SharedWitness) -> dict:
        d = self.d
        fr = d.fr
        host = d.curve.fr
        st = SimpleNamespace(zk=zk, n=zk.domain_size, n4=4 * zk.domain_size,
                             root=host.root_of_unity(zk.power),
                             root4=host.root_of_unity(zk.power + 2),
                             root2=host.root_of_unity(2),
                             p_tau=d.g1_proj(zk.p_tau))
        tr = self.tracer
        st.publics, W = self._build_witness(zk, shared)
        if self.deterministic:
            st.bs = [d.index_share(d.promote_public(fr.encode([i])), 0) for i in range(11)]
        else:
            st.bs = [d.rand(()) for _ in range(11)]
        with tr.span(ROUND_SPANS[0]):
            self._round1(st, W)
        del W
        with tr.span(ROUND_SPANS[1]):
            self._round2(st)
        with tr.span(ROUND_SPANS[2]):
            self._round3(st)
        with tr.span(ROUND_SPANS[3]):
            self._round4(st)
        with tr.span(ROUND_SPANS[4]):
            self._round5(st)
        proof = {"curve": d.curve}
        for k in ("A", "B", "C", "Z", "T1", "T2", "T3", "Wxi", "Wxiw", "eval_a", "eval_b",
                  "eval_c", "eval_s1", "eval_s2", "eval_zw"):
            proof[k] = getattr(st, k)
        return proof

    def _round1(self, st, W):
        d, zk, n = self.d, st.zk, st.n

        def wire_buffer(mapping):
            idx = np.zeros(n, np.int64)
            idx[: zk.n_constraints] = mapping
            buf = d.gather(W, idx)
            if zk.n_constraints < n:  # zero out the padding lanes
                mask = torch.zeros((1, n), dtype=torch.int32, device=d.device)
                mask[0, : zk.n_constraints] = 1
                buf = pmap(lambda c: c * mask, buf)
            return buf

        st.buf_a, st.buf_b, st.buf_c = (wire_buffer(m) for m in (zk.map_a, zk.map_b, zk.map_c))
        polys = []
        for k, buf in enumerate((st.buf_a, st.buf_b, st.buf_c)):
            poly = d.ifft(buf)
            setattr(st, "ev_" + "abc"[k], self._fft4(st, poly))
            polys.append(self._blind(poly, st.bs[2 * k: 2 * k + 2]))
        st.poly_a, st.poly_b, st.poly_c = polys
        st.A, st.B, st.C = self._commit_open(st, polys)

    def _round2(self, st):
        d, fr, zk, n = self.d, self.d.fr, st.zk, st.n
        ts = Keccak256Transcript(d.curve)
        for pt in (zk.qm_c, zk.ql_c, zk.qr_c, zk.qo_c, zk.qc_c, zk.s1_c, zk.s2_c, zk.s3_c):
            ts.add_point(pt)
        for v in st.publics:
            ts.add_scalar(v)
        for pt in (st.A, st.B, st.C):
            ts.add_point(pt)
        st.beta = beta = ts.get_challenge()
        ts = Keccak256Transcript(d.curve)
        ts.add_scalar(beta)
        st.gamma = gamma = ts.get_challenge()

        w_pows = power_table(fr, st.root, n)
        gamma_c = self._c(gamma)

        def lin(buf, pub):
            """buf + pub + gamma."""
            return d.add_public(buf, fr.add(pub, gamma_c))

        n1 = lin(st.buf_a, fr.mont_mul(w_pows, self._c(beta)))
        n2 = lin(st.buf_b, fr.mont_mul(w_pows, self._c(beta * zk.k1)))
        n3 = lin(st.buf_c, fr.mont_mul(w_pows, self._c(beta * zk.k2)))
        dd1 = lin(st.buf_a, fr.mont_mul(zk.s1.evals[:, ::4], self._c(beta)))
        dd2 = lin(st.buf_b, fr.mont_mul(zk.s2.evals[:, ::4], self._c(beta)))
        dd3 = lin(st.buf_c, fr.mont_mul(zk.s3.evals[:, ::4], self._c(beta)))
        del st.buf_b, st.buf_c

        # batch the two pair-products into one round, then the two triples
        p12 = d.mul_vec(d.concat_shares(n1, dd1), d.concat_shares(n2, dd2))
        p123 = d.mul_vec(p12, d.concat_shares(n3, dd3))
        del p12, n1, n2, n3, dd1, dd2, dd3
        num_pref = d.prefix_mul(d.slice_share(p123, 0, n))
        den_pref = d.prefix_mul(d.slice_share(p123, n, 2 * n))
        del p123
        z_buf = d.mul_vec(num_pref, d.inv_many(den_pref))
        z_buf = pmap(lambda c: torch.roll(c, 1, dims=1), z_buf)

        poly_z = d.ifft(z_buf)
        st.ev_z = self._fft4(st, poly_z)
        st.poly_z = self._blind(poly_z, st.bs[6:9])
        (st.Z,) = self._commit_open(st, [st.poly_z])

    def _round3(self, st):
        d, fr, zk, n, n4 = self.d, self.d.fr, st.zk, st.n, st.n4
        bs, beta, gamma = st.bs, st.beta, st.gamma
        ts = Keccak256Transcript(d.curve)
        ts.add_scalar(beta)
        ts.add_scalar(gamma)
        ts.add_point(st.Z)
        st.alpha = alpha = ts.get_challenge()
        alpha2 = alpha * alpha % fr.p

        w4 = power_table(fr, st.root4, n4)
        col = lambda s: pmap(lambda c: c.reshape(c.shape[0], 1), s)  # noqa: E731

        def lin2(b_hi, b_lo, pows):
            """b_hi * pows + b_lo for blinding scalars b_hi, b_lo."""
            return d.add(d.mul_public(col(b_hi), pows), col(b_lo))

        ap, bp, cp = lin2(bs[0], bs[1], w4), lin2(bs[2], bs[3], w4), lin2(bs[4], bs[5], w4)
        w4_sq = fr.mont_mul(w4, w4)
        zp = d.add(d.mul_public(col(bs[6]), w4_sq), lin2(bs[7], bs[8], w4))
        ww = fr.mont_mul(w4, self._c(st.root))
        zwp = d.add(d.mul_public(col(bs[6]), fr.mont_mul(ww, ww)), lin2(bs[7], bs[8], ww))
        del w4_sq, ww

        # z1/z2/z3 degree-correction patterns (period 4): the 4 values,
        # encoded once and repeated on the device
        p, r2 = fr.p, st.root2
        z1p, z2p, z3p = (fr.encode([v % p for v in vals]).repeat(1, n) for vals in (
            (0, -1 + r2, -2, -1 - r2), (0, -2 * r2, 4, 2 * r2), (0, 2 + 2 * r2, -8, 2 - 2 * r2)))

        ev_a, ev_b, ev_c, ev_z = st.ev_a, st.ev_b, st.ev_c, st.ev_z
        del st.ev_a, st.ev_b, st.ev_c, st.ev_z
        sl = lambda x, k: d.slice_share(x, k * n4, (k + 1) * n4)  # noqa: E731

        # wave A: the 4 e1/e1z products in ONE round
        wA = _mul_owned(d, [d.concat_shares(ev_a, ev_a, ap, ap),
                            d.concat_shares(ev_b, bp, ev_b, bp)])
        a_b, a_bp, ap_b, ap_bp = (sl(wA, k) for k in range(4))

        qm4, ql4, qr4 = zk.qm.evals, zk.ql.evals, zk.qr.evals
        qo4, qc4 = zk.qo.evals, zk.qc.evals
        e1 = d.mul_public(a_b, qm4)
        e1 = d.add(e1, d.mul_public(ev_a, ql4))
        e1 = d.add(e1, d.mul_public(ev_b, qr4))
        e1 = d.add(e1, d.mul_public(ev_c, qo4))
        e1 = d.add_public(e1, qc4)
        for j in range(zk.n_public):
            lj = zk.lagrange[j].evals
            e1 = d.sub(e1, d.mul_public(col(d.index_share(st.buf_a, j)), lj))
        del st.buf_a

        e1z = d.add(d.add(a_bp, ap_b), d.mul_public(ap_bp, z1p))
        del wA, a_b, a_bp, ap_b, ap_bp
        e1z = d.mul_public(e1z, qm4)
        e1z = d.add(e1z, d.mul_public(ap, ql4))
        e1z = d.add(e1z, d.mul_public(bp, qr4))
        e1z = d.add(e1z, d.mul_public(cp, qo4))

        def beta_g(pub, k):
            """pub * beta * k + gamma."""
            return fr.add(fr.mont_mul(pub, self._c(beta * k)), self._c(gamma))

        e2a = d.add_public(ev_a, beta_g(w4, 1))
        e2b = d.add_public(ev_b, beta_g(w4, zk.k1))
        e2c = d.add_public(ev_c, beta_g(w4, zk.k2))
        e3a = d.add_public(ev_a, beta_g(zk.s1.evals, 1))
        e3b = d.add_public(ev_b, beta_g(zk.s2.evals, 1))
        e3c = d.add_public(ev_c, beta_g(zk.s3.evals, 1))
        del ev_a, ev_b, ev_c
        zw_ev = pmap(lambda c: torch.roll(c, -4, dims=1), ev_z)

        # mul4vec for e2 = e2a*e2b*e2c*z and e3 = e3a*e3b*e3c*zw, with ALL
        # blinding cross terms (round3.rs mul4vec/mul4vec_post).  Stage 1:
        # the 16 pair products (a-side x4, c-side x4, both branches), ONE round.
        operands = [d.concat_shares(e2a, e2a, ap, ap, e2c, e2c, cp, cp,
                                    e3a, e3a, ap, ap, e3c, e3c, cp, cp),
                    d.concat_shares(e2b, bp, e2b, bp, ev_z, zp, ev_z, zp,
                                    e3b, bp, e3b, bp, zw_ev, zwp, zw_ev, zwp)]
        del e2a, e2b, e2c, e3a, e3b, e3c, zw_ev, zwp, ap, bp, cp
        wB = _mul_owned(d, operands)
        # per branch: P=a*b, R=a*bp, Q=ap*b, S=ap*bp ; U=c*d, W=c*dp, V=cp*d, X=cp*dp
        P2, R2, Q2, S2, U2, W2, V2, X2 = (sl(wB, k) for k in range(8))
        P3, R3, Q3, S3, U3, W3, V3, X3 = (sl(wB, k) for k in range(8, 16))

        # Stage 2: the full 16-combination outer products per branch, ONE round
        lhs, rhs = [], []
        for pts, uts in (((P2, Q2, R2, S2), (U2, V2, W2, X2)),
                         ((P3, Q3, R3, S3), (U3, V3, W3, X3))):
            for pterm in pts:
                for uterm in uts:
                    lhs.append(pterm)
                    rhs.append(uterm)
        del P2, R2, Q2, S2, U2, W2, V2, X2, P3, R3, Q3, S3, U3, W3, V3, X3
        operands = [d.concat_shares(*lhs), d.concat_shares(*rhs)]
        del lhs, rhs, wB
        wD = _mul_owned(d, operands)

        def combine(base_k):
            # g(p, u): p, u in 0..3 over (P, Q, R, S) x (U, V, W, X)
            g = lambda p, u: sl(wD, base_k + 4 * p + u)  # noqa: E731
            a0 = d.add(d.add(g(1, 0), g(2, 0)), d.add(g(0, 1), g(0, 2)))
            a1 = d.add(d.add(d.add(g(3, 0), g(1, 1)), d.add(g(1, 2), g(2, 1))),
                       d.add(g(2, 2), g(0, 3)))
            a2 = d.add(d.add(g(2, 3), g(1, 3)), d.add(g(3, 2), g(3, 1)))
            ez = d.add(d.add(a0, d.mul_public(a1, z1p)),
                       d.add(d.mul_public(a2, z2p), d.mul_public(g(3, 3), z3p)))
            return pmap(torch.clone, g(0, 0)), ez   # a copy: wD can be freed

        e2, e2z = combine(0)
        e3, e3z = combine(16)
        del wD

        # t = e1 + alpha(e2 - e3) + alpha^2 * L1*(z-1)
        l1_4 = zk.lagrange[0].evals
        e4 = d.mul_public(d.add_public(ev_z, self._c(-1)), l1_4)
        del ev_z
        t_ev = d.add(e1, d.mul_public(d.sub(e2, e3), self._c(alpha)))
        t_ev = d.add(t_ev, d.mul_public(e4, self._c(alpha2)))
        del e1, e2, e3, e4
        tz_ev = d.add(e1z, d.mul_public(d.sub(e2z, e3z), self._c(alpha)))
        tz_ev = d.add(tz_ev, d.mul_public(d.mul_public(zp, l1_4), self._c(alpha2)))
        del e1z, e2z, e3z, zp

        coeff_t = d.ifft(t_ev)
        # divide by Z_H = X^n - 1 (sequential over the 4 chunks, local)
        chunks = [d.neg(d.slice_share(coeff_t, 0, n))]
        for k in range(1, 4):
            chunks.append(d.sub(chunks[k - 1], d.slice_share(coeff_t, k * n, (k + 1) * n)))
        t_final = d.add(d.concat_shares(*chunks), d.ifft(tz_ev))
        del coeff_t, chunks, t_ev, tz_ev

        b9, b10 = d.stack_shares([bs[9]]), d.stack_shares([bs[10]])
        st.t1 = d.concat_shares(d.slice_share(t_final, 0, n), b9)
        st.t2 = d.concat_shares(d.sub(d.slice_share(t_final, n, n + 1), b9),
                                d.slice_share(t_final, n + 1, 2 * n), b10)
        st.t3 = d.concat_shares(d.sub(d.slice_share(t_final, 2 * n, 2 * n + 1), b10),
                                d.slice_share(t_final, 2 * n + 1, 3 * n + 6))
        del t_final
        st.T1, st.T2, st.T3 = self._commit_open(st, [st.t1, st.t2, st.t3])

    def _round4(self, st):
        d, fr, zk = self.d, self.d.fr, st.zk
        ts = Keccak256Transcript(d.curve)
        ts.add_scalar(st.alpha)
        for pt in (st.T1, st.T2, st.T3):
            ts.add_point(pt)
        st.xi = xi = ts.get_challenge()
        st.xiw = xi * st.root % fr.p

        evs = [d.evaluate_poly_public(st.poly_a, xi), d.evaluate_poly_public(st.poly_b, xi),
               d.evaluate_poly_public(st.poly_c, xi), d.evaluate_poly_public(st.poly_z, st.xiw)]
        vals = fr.decode(d.open_many(d.stack_shares(evs)))
        st.eval_a, st.eval_b, st.eval_c, st.eval_zw = (int(v) for v in vals)
        xi_pows = power_table(fr, xi, st.n)
        st.eval_s1, st.eval_s2 = (int(fr.decode(fr.sum(fr.mont_mul(s.coeffs, xi_pows))))
                                  for s in (zk.s1, zk.s2))

    def _round5(self, st):
        d, fr, zk, n = self.d, self.d.fr, st.zk, st.n
        p = fr.p
        xi, beta, gamma, alpha = st.xi, st.beta, st.gamma, st.alpha
        ts = Keccak256Transcript(d.curve)
        ts.add_scalar(xi)
        for v in (st.eval_a, st.eval_b, st.eval_c, st.eval_s1, st.eval_s2, st.eval_zw):
            ts.add_scalar(v)
        v0 = ts.get_challenge()
        vv = [v0]
        for _ in range(4):
            vv.append(vv[-1] * v0 % p)

        # public Lagrange evaluations at xi
        xin = pow(xi, n, p)
        zh = (xin - 1) % p
        l_evals = []
        w = 1
        for _ in range(max(1, zk.n_public)):
            l_evals.append(w * zh % p * pow(n * (xi - w) % p, -1, p) % p)
            w = w * st.root % p
        eval_pi = (-sum(lv * v for lv, v in zip(l_evals, st.publics))) % p

        ea, eb, ec = st.eval_a, st.eval_b, st.eval_c
        betaxi = beta * xi % p
        e2_s = ((ea + betaxi + gamma) * (eb + betaxi * zk.k1 + gamma) % p
                * (ec + betaxi * zk.k2 + gamma) % p * alpha % p)
        e3_s = ((ea + beta * st.eval_s1 + gamma) * (eb + beta * st.eval_s2 + gamma) % p
                * st.eval_zw % p * alpha % p)
        e4_s = (st.alpha * st.alpha % p) * l_evals[0] % p
        len5 = n + 6

        def mulc(pub, k):
            return fr.mont_mul(pub, self._c(k))

        def fit(pub):
            return _pad_share(pub, len5)

        r_pub = mulc(fit(zk.qm.coeffs), ea * eb)
        r_pub = fr.add(r_pub, mulc(fit(zk.ql.coeffs), ea))
        r_pub = fr.add(r_pub, mulc(fit(zk.qr.coeffs), eb))
        r_pub = fr.add(r_pub, mulc(fit(zk.qo.coeffs), ec))
        r_pub = fr.add(r_pub, fit(zk.qc.coeffs))
        r_pub = fr.add(r_pub, mulc(fit(zk.s3.coeffs), -(e3_s * beta)))

        poly_r = d.add_public(d.mul_public(fit(st.poly_z), self._c(e2_s + e4_s)), r_pub)
        tmp = d.mul_public(fit(st.t3), self._c(xin * xin))
        tmp = d.add(tmp, d.mul_public(fit(st.t2), self._c(xin)))
        tmp = d.add(tmp, fit(st.t1))
        poly_r = d.sub(poly_r, d.mul_public(tmp, self._c(zh)))
        del tmp, r_pub
        r0 = eval_pi - e3_s * ((ec + gamma) % p) - e4_s
        poly_r = d.add_public(poly_r, self._at0(r0, len5))

        # W_xi
        wxi = poly_r
        for poly, v in ((st.poly_a, vv[0]), (st.poly_b, vv[1]), (st.poly_c, vv[2])):
            wxi = d.add(wxi, d.mul_public(fit(poly), self._c(v)))
        wxi = d.add_public(wxi, mulc(fit(zk.s1.coeffs), vv[3]))
        wxi = d.add_public(wxi, mulc(fit(zk.s2.coeffs), vv[4]))
        const0 = (vv[0] * ea + vv[1] * eb + vv[2] * ec + vv[3] * st.eval_s1
                  + vv[4] * st.eval_s2) % p
        wxi = self._div_by_x_minus(d.add_public(wxi, self._at0(-const0, len5)), xi)
        del poly_r

        # W_xiw
        m = leaves(st.poly_z)[0].shape[1]
        wxiw = self._div_by_x_minus(d.add_public(st.poly_z, self._at0(-st.eval_zw, m)), st.xiw)
        st.Wxi, st.Wxiw = self._commit_open(st, [wxi, wxiw])

    def _div_by_x_minus(self, poly_share, beta: int):
        """Synthetic division by (X - beta): q_i = -(sum_{j<=i} c_j b^j) / b^{i+1}.
        Local (prefix sums per share component).  Parity: round5.rs
        div_by_zerofier with n=1."""
        d = self.d
        fr = d.fr
        m = leaves(poly_share)[0].shape[1]
        binv = pow(beta, -1, fr.p)
        scaled = d.mul_public(poly_share, power_table(fr, beta, m))
        pref = pmap(fr.prefix_sums, scaled)
        q = d.mul_public(pref, fr.mont_mul(power_table(fr, binv, m), self._c(-binv)))
        return d.slice_share(q, 0, m - 1)
