"""co-UltraHonk: the MPC twin of the plain UltraHonk prover, generic over
an MPC driver (Plain, REP3, Shamir).

Parity: upstream co-noir/co-ultrahonk/src/ — prover.rs :47-60,
co_oink/prover.rs (shared w4 :54, logderiv inverses :185, grand product
via the constant-round prefix trick :303-329), co_decider/co_sumcheck
(prover.rs :25-55, round.rs), co_decider/co_zeromorph/prover.rs,
parse/builder_variable.rs (public/shared circuit values).

Batched redesigns vs the reference (as the JAX package's co_prover.py):
  * relation accumulation runs the SAME formulas as the plain prover
    (relations.py) through the Pub/Sh wrapper algebra (co_alg.py) over
    whole (L, 8, E) edge tensors, and the share products of one
    multiplicative depth, across all 26 subrelations, are ONE batched
    communication round (`CoAlg.batched`): four a sumcheck round where the
    reference's co relations call mul_many per relation and edge;
  * z_perm uses the Ozdemir-Boneh constant-round prefix product
    (driver.prefix_mul) instead of a sequential scan;
  * the setup commits the shares (`commit_shares`, `commit_opening` of
    honk/crs.py), the polynomials committed together in one call:
    (w_l, w_r, w_o), (read counts, read tags, w_4), the lookup inverses,
    z_perm, the log n ZeroMorph quotients (zero-padded to one length),
    C_q, and the KZG quotient.  Over a setup of points (PointCrs), as
    upstream CoUtils::commit, each is an MSM over the shares (the driver's
    msm_g1_many, then open_point), the KZG quotient computed as
    coefficients on the shares (`opening_quotient`: the division by X - x
    is linear).  Over a known-tau setup (TestCrs, tests and --crs test)
    each is a local evaluation at tau and one product with the generator
    (`open_gen`), the KZG quotient's q(tau)*G = pi(tau)/(tau-x)*G.

Differences from the JAX package, none of which changes a proof byte:
  * the sumcheck's tensors shrink with each round (the JAX package pads
    them back to n/2 to keep its compiled shapes; PyTorch compiles
    nothing);
  * a round's relations run over the edges in chunks of at most
    EDGE_CHUNK (round 0 at n = 2^20 would hold about 15 GiB a party at
    once); the univariate is a sum over edges, so only the MPC masks of
    the chunked products differ, and those cancel when opened;
  * the commitments' products with the generator go through a window
    table (GeneratorTable) instead of a double-and-add, and under Shamir
    each party sends its share point already Lagrange-weighted
    (`open_gen`): the same points, far fewer curve adds.

The proof bytes equal the plain prover's for the same witness and CRS
(asserted in tests): the MPC changes only WHO computes, not what.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mpc.rep3 import Rep3FieldShare, Rep3PointShare
from ..ops.curve import ProjPoint, leaves, pmap
from ..utils.trace import tracer_or_null
from .builder import NUM_WIRES, P, UltraCircuitBuilder
from .co_alg import CoAlg, Pub, Sh
from .proving_key import Q_LOOKUP, create_proving_key
from . import relations
from .relations import (
    ALL_ENTITY_NAMES,
    NUM_ALPHAS,
    PRECOMPUTED_NAMES,
    SUBRELATION_IS_LINEARLY_INDEPENDENT,
    SUBRELATION_LENGTHS,
)
from .sumcheck import (
    _EXT_CACHE,
    BATCHED_LENGTH,
    CONST_PROOF_SIZE_LOG_N,
    GateSeparator,
    _extension_matrix,
)
from .transcript import Transcript
from .zeromorph import F_NAMES, G_NAMES, G_SHIFT_NAMES

SHARED_ENTITIES = ("w_l", "w_r", "w_o", "w_4", "z_perm", "lookup_inverses")
EDGE_CHUNK = 1 << 16


def wire_index_maps(builder: UltraCircuitBuilder, n: int):
    """Trace-order variable indices per wire column — the gather the plain
    proving key performs on VALUES, kept as indices so the shared prover
    gathers share handles instead (builder gate layout is
    witness-independent for the supported circuits)."""
    from .builder import BLOCK_ORDER

    # default: the ZERO sentinel slot (appended after all real variables)
    # — the zero row and dyadic padding rows must gather value 0, not
    # variable 0
    zero_slot = len(builder.variables)
    idx = [np.full(n, zero_slot, np.int64) for _ in range(NUM_WIRES)]
    real = np.asarray(builder.real_variable_index, np.int64)
    offset = 1
    for name in BLOCK_ORDER:
        blk = builder.blocks[name]
        rows = len(blk)
        for w in range(NUM_WIRES):
            if rows:
                idx[w][offset: offset + rows] = real[np.asarray(blk.wires[w][:rows], np.int64)]
        offset += rows
    return idx


def _shift(c):
    """Shift a limb tensor left by one along its last axis, zero-filled."""
    out = torch.zeros_like(c)
    out[..., :-1] = c[..., 1:]
    return out


def _place(c, offset: int, total: int):
    """c placed at [offset, offset + len) of a zero tensor of length total."""
    out = torch.zeros(c.shape[:-1] + (total,), dtype=c.dtype, device=c.device)
    out[..., offset: offset + c.shape[-1]] = c
    return out


def _set_cols(vec, cols, vals):
    """Copy of a share vec with columns `cols` set to vals."""
    def put(base, v):
        out = base.clone()
        out[..., cols] = v
        return out

    return pmap(put, vec, vals)


class GeneratorTable:
    """s * G for the CRS generator G (public) by a window table:
    table[w, k] = k * 16^w * G for the 64 four-bit windows of a 256-bit
    scalar, built once on the host.  A product is one lookup a window and a
    tree sum over the windows (six batched complete adds, K4 on the card)
    in place of a 64-window double-and-add (about 320 adds)."""

    W = 4

    def __init__(self, ops, gen_host):
        from ..fields.ec_host import ec_add

        rows = []
        base = gen_host
        nwin = 256 // self.W
        for _ in range(nwin):
            row, cur = [None], None
            for _ in range((1 << self.W) - 1):
                cur = ec_add(cur, base)
                row.append(cur)
            rows += [None if q is None else (q[0].v, q[1].v) for q in row]
            base = ec_add(cur, base)
        self.ops = ops
        self.nwin = nwin
        self.table = ops.encode_points(rows)  # (L, nwin * 16)

    def mul(self, scalar_limbs):
        """(Ls, k) standard-form 32-bit limbs -> (L, k) points."""
        W = self.W
        s64 = scalar_limbs.to(torch.int64) & 0xFFFFFFFF
        shifts = torch.arange(0, 32, W, device=s64.device)
        digits = (s64.unsqueeze(1) >> shifts.reshape(1, -1, 1)) & ((1 << W) - 1)
        digits = digits.reshape(-1, s64.shape[-1])[: self.nwin]  # (nwin, k)
        idx = (digits + (torch.arange(self.nwin, device=s64.device) << W)[:, None]).t()
        flat = idx.reshape(-1)
        entries = pmap(lambda c: c.index_select(1, flat).reshape(
            (c.shape[0],) + tuple(idx.shape)), self.table)  # (L, k, nwin)
        return self.ops.sum(entries, axis=2)


_GEN_TABLES: dict = {}

SPAN_COMMIT = "honk.commit"  # the setup's commit of a group of shared polynomials


def _gen_table(d, gen) -> GeneratorTable:
    """The window table of the host point `gen` on d's device, made once."""
    key = (d.device, gen[0].v, gen[1].v)
    if key not in _GEN_TABLES:
        _GEN_TABLES[key] = GeneratorTable(d.g1, gen)
    return _GEN_TABLES[key]


def open_gen(d, share, gen) -> list:
    """share * G opened (G = gen, a public host point), for a share of a
    (k,) vector: host affine points.  Each share component's scalars go
    through the generator's window table, so a product is local and cheap;
    the opening is the driver's point opening.  Under Shamir each party
    sends every receiver its share already weighted by the receiver's
    Lagrange coefficient (lam * s_j * G in place of s_j * G: the same
    information, lam public and non-zero), so the receivers add points
    where `open_point` would multiply each by a full-width scalar."""
    tab = _gen_table(d, gen)
    if d.protocol == "shamir":
        return d.g1.decode_points(_open_gen_shamir(d, share, tab))
    sc = d.to_scalars(share)
    if isinstance(sc, Rep3FieldShare):
        pts = Rep3PointShare(tab.mul(sc.a), tab.mul(sc.b))
    else:
        pts = tab.mul(sc)
    return d.g1.decode_points(d.open_point(d.g1, pts))


def _open_gen_shamir(d, share, tab):
    from ..mpc.shamir import _lagrange_at_zero

    n, t, me = d.n, d.t, d.id
    k = share.shape[1]
    weighted = []
    for j in range(t + 1):
        # receiver r = me + j combines parties r, r-1, ..., r-t; this
        # party is its j-th
        r = (me + j) % n
        lam = _lagrange_at_zero(d.curve.fr, [((r - m) % n) + 1 for m in range(t + 1)])[j]
        weighted.append(d.mul_public(share, d.fr.const_mont(lam)[:, None]))
    pts = tab.mul(d.to_scalars(d.concat_shares(*weighted)))  # (L, (t+1) k)
    for j in range(1, t + 1):
        d.net.send((me + j) % n, pmap(lambda c, j=j: c[:, j * k:(j + 1) * k], pts))
    acc = pmap(lambda c: c[:, :k], pts)
    for j in range(1, t + 1):
        acc = d.g1.add(acc, ProjPoint(*d._recv((me - j) % n)))
    return acc


def opening_quotient(d, pi, x: int):
    """Shares of the KZG quotient (pi(X) - pi(x)) / (X - x) of a shared pi
    of n coefficients, as coefficients: the n - 1 of
    `zeromorph.compute_opening_proof`'s division by (X - x), which are
    q_i = -x^-(i+1) sum_{j <= i} pi_j x^j.  Linear in pi, so each party
    computes them on its own shares: a product with the powers of x, prefix
    sums, a product with the powers of -1/x."""
    from ..ops.ntt import power_table

    f = d.fr
    n = leaves(pi)[0].shape[-1]
    if x % P == 0:
        return d.slice_share(pi, 1, n)
    x_inv = pow(x, -1, P)
    terms = d.mul_public(pi, power_table(f, x, n))
    sums = pmap(lambda c: f.prefix_sums(c, axis=1), terms)
    scale = f.mont_mul(power_table(f, x_inv, n), f.const_mont((P - x_inv) % P)[:, None])
    return d.slice_share(d.mul_public(sums, scale), 0, n - 1)


class CoUltraHonk:
    def __init__(self, driver, crs, tracer=None):
        self.d = driver
        self.f = driver.fr
        self.crs = crs
        self.alg = CoAlg(driver)
        self.tr = tracer_or_null(tracer)

    # ------------------------------------------------------------ helpers

    def _enc(self, ints):
        return self.f.encode(list(ints))

    def _idx(self, ints):
        return torch.as_tensor(np.asarray(ints, np.int64), device=self.d.device)

    def _commit_open(self, poly_shares: list) -> list:
        """The commitments to shared polynomials of one length, opened: host
        affine points, under one `honk.commit` span.  The setup commits
        them (`commit_shares`): an MSM over the shares (PointCrs) or local
        evaluations at a known tau (TestCrs)."""
        with self.tr.span(SPAN_COMMIT):
            return self.crs.commit_shares(self.d, poly_shares)

    def _open_frs(self, share) -> list[int]:
        vals = self.f.decode(self.d.open_many(share))
        return [int(v) % P for v in np.atleast_1d(vals)]

    # -------------------------------------------------------------- prove

    def prove(self, builder: UltraCircuitBuilder, witness_share) -> list[int]:
        """The proof (HonkProof field elements) of the builder's circuit from
        this party's witness share.  It runs under torch.inference_mode: no
        tensor of the proof needs autograd's bookkeeping, which costs about
        a quarter of a small op's time."""
        with torch.inference_mode():
            return self._prove(builder, witness_share)

    def _prove(self, builder: UltraCircuitBuilder, witness_share) -> list[int]:
        d = self.d
        f = self.f
        alg = self.alg
        tr = self.tr
        with tr.span("keys (create_proving_key)"):
            pk = create_proving_key(builder, self.crs)
        n = pk.circuit_size
        varnum = leaves(witness_share)[0].shape[-1]

        with tr.span("oink: wires"):
            # shared variables vector: witness shares ++ builder extras.
            # Extras are public constants unless the builder ran in
            # provider mode (co_builder.MpcBuilderValues — e.g. shared ROM
            # records), in which case the registered share handles
            # overwrite their slots.  The trailing slot is the ZERO
            # sentinel the padding rows gather.
            extra_vals = [builder.variables[i]
                          for i in range(varnum, len(builder.variables))] + [0]
            extra = d.promote_public(self._enc(extra_vals))
            m = getattr(builder, "mpc", None)
            if m is not None and m.extra:
                order = sorted(m.extra)
                cols = d.concat_shares(*(m.extra[i] for i in order))
                extra = _set_cols(extra, self._idx(np.asarray(order) - varnum), cols)
            vars_vec = d.concat(witness_share, extra)

            idx = wire_index_maps(builder, n)
            wires_sh = [d.gather(vars_vec, i) for i in idx]
            del vars_vec, extra

            pub_idx = np.asarray(
                [pk.pub_inputs_offset + i for i in range(pk.num_public_inputs)],
                np.int64)
            public_inputs = self._open_frs(d.gather(wires_sh[1], pub_idx)) \
                if pk.num_public_inputs else []

            t = Transcript()
            t.send_u64("circuit_size", n)
            t.send_u64("public_input_size", pk.num_public_inputs)
            t.send_u64("pub_inputs_offset", pk.pub_inputs_offset)
            for i, x in enumerate(public_inputs):
                t.send_fr("public_input_%d" % i, x)

            for label, pt in zip(
                ("W_L", "W_R", "W_O"),
                self._commit_open(wires_sh[:3]),
            ):
                t.send_point(label, pt)

        # ---------------- eta round: w4 (+ memory records) ----------------
        with tr.span("oink: w_4 and lookups"):
            eta_1, eta_2, eta_3 = t.get_challenges(["eta", "eta_two", "eta_three"])
            w_4 = wires_sh[3]

            def _eta_combo(rows):
                """w_l*eta + w_r*eta_2 + w_o*eta_3 at rows (local on shares:
                the etas are public)."""
                r = self._idx(rows)
                terms = [d.mul_public(d.gather(wires_sh[k], r), f.const_mont(e)[:, None])
                         for k, e in enumerate((eta_1, eta_2, eta_3))]
                return r, d.add(terms[0], d.add(terms[1], terms[2]))

            # shared twin of the plain oink fill (prover.py:92-97): at
            # memory rows w_4 += w_l*eta + w_r*eta_2 + w_o*eta_3 (+1 for
            # writes)
            for rows, add_one in ((pk.memory_read_records, 0),
                                  (pk.memory_write_records, 1)):
                if not rows:
                    continue
                r, combo = _eta_combo(rows)
                combo = d.add(d.gather(w_4, r), combo)
                if add_one:
                    combo = d.add_public(combo, f.const_mont(1)[:, None])
                w_4 = _set_cols(w_4, r, combo)
            mixed = getattr(pk, "memory_mixed_records", None)
            if mixed:
                # oblivious-sorted RAM rows: w_4 += eta-combo + [access]
                # where the access type is a SHARE (secret sort permutation)
                r, combo = _eta_combo(mixed)
                acc_vec = d.concat_shares(*m.mixed_access)
                combo = d.add(d.gather(w_4, r), d.add(acc_vec, combo))
                w_4 = _set_cols(w_4, r, combo)
            read_counts, read_tags = pk.witness[4], pk.witness[5]
            rc_pub = self._enc(read_counts)
            rt_pub = self._enc(read_tags)
            for label, pt in zip(
                ("LOOKUP_READ_COUNTS", "LOOKUP_READ_TAGS", "W_4"),
                self._commit_open(
                    [d.promote_public(rc_pub), d.promote_public(rt_pub), w_4]),
            ):
                t.send_point(label, pt)

        # ---------------- beta/gamma: logderiv inverses ----------------
        with tr.span("oink: lookup inverses"):
            beta, gamma = t.get_challenges(["beta", "gamma"])
            pre = pk.precomputed
            pre_pub = {name: self._enc(pre[i])
                       for i, name in enumerate(PRECOMPUTED_NAMES)}

            w = {k: Sh(alg, v) for k, v in zip(
                ("w_l", "w_r", "w_o", "w_4"), (*wires_sh[:3], w_4))}
            ws = {k + "_shift": Sh(alg, pmap(_shift, v.v)) for k, v in w.items()}
            q = {k: Pub(alg, v) for k, v in pre_pub.items()}
            g_c = alg.pub_of_int(gamma)
            e1c, e2c, e3c = (alg.pub_of_int(eta_1), alg.pub_of_int(eta_2),
                             alg.pub_of_int(eta_3))

            read_term = (
                (w["w_l"] + g_c + q["q_r"] * ws["w_l_shift"])
                + (w["w_r"] + q["q_m"] * ws["w_r_shift"]) * e1c
                + (w["w_o"] + q["q_c"] * ws["w_o_shift"]) * e2c
                + q["q_o"] * e3c
            )
            write_term = (q["table_1"] + g_c + q["table_2"] * e1c
                          + q["table_3"] * e2c + q["table_4"] * e3c)
            prod = read_term * write_term  # Sh x Pub: local
            del read_term, write_term, ws

            active = self._idx(np.flatnonzero(
                (np.asarray(pre[Q_LOOKUP], dtype=object) == 1)
                | (np.asarray(read_tags, dtype=object) == 1)))
            lookup_inverses = pmap(torch.zeros_like, prod.v)
            if active.numel():
                inv_active = d.inv_many(d.gather(prod.v, active))
                lookup_inverses = _set_cols(lookup_inverses, active, inv_active)
            del prod
            t.send_point("LOOKUP_INVERSES",
                         self._commit_open([lookup_inverses])[0])

        # ---------------- grand product ----------------
        with tr.span("oink: z_perm"):
            from .prover import compute_public_input_delta

            public_input_delta = compute_public_input_delta(
                beta, gamma, public_inputs, n, pk.pub_inputs_offset)
            b_c = alg.pub_of_int(beta)

            def factors():
                num = den = None
                for col, wn in enumerate(("w_l", "w_r", "w_o", "w_4")):
                    fac_n = w[wn] + q[PRECOMPUTED_NAMES[17 + col]] * b_c + g_c
                    fac_d = w[wn] + q[PRECOMPUTED_NAMES[13 + col]] * b_c + g_c
                    num = fac_n if num is None else num * fac_n
                    den = fac_d if den is None else den * fac_d
                return num, den

            num, den = alg.batched(factors)  # the two products of a depth as one round
            pref_num = d.prefix_mul(num.v)
            pref_den = d.prefix_mul(den.v)
            del num, den, w, q
            inv_den = d.inv_many(d.slice_share(pref_den, 0, n - 1))
            z_tail = d.mul_vec(d.slice_share(pref_num, 0, n - 1), inv_den)
            del pref_num, pref_den, inv_den
            z_perm = pmap(lambda c: _place(c, 1, n), z_tail)
            t.send_point("Z_PERM",
                         self._commit_open([z_perm])[0])

        alphas = [t.get_challenge("alpha_%d" % i) for i in range(NUM_ALPHAS)]
        gate_challenges = [t.get_challenge("Sumcheck:gate_challenge_%d" % i)
                           for i in range(CONST_PROOF_SIZE_LOG_N)]

        rp = {"eta_1": eta_1, "eta_2": eta_2, "eta_3": eta_3, "beta": beta,
              "gamma": gamma, "public_input_delta": public_input_delta,
              "alphas": alphas, "gate_challenges": gate_challenges}

        # ---------------- entity polynomials ----------------
        pub_polys = dict(pre_pub)
        pub_polys["lookup_read_counts"] = rc_pub
        pub_polys["lookup_read_tags"] = rt_pub
        for k in ("table_1", "table_2", "table_3", "table_4"):
            pub_polys[k + "_shift"] = _shift(pub_polys[k])
        sh_polys = {"w_l": wires_sh[0], "w_r": wires_sh[1],
                    "w_o": wires_sh[2], "w_4": w_4, "z_perm": z_perm,
                    "lookup_inverses": lookup_inverses}
        for k in SHARED_ENTITIES[:5]:
            sh_polys[k + "_shift"] = pmap(_shift, sh_polys[k])
        del wires_sh, w_4, z_perm, lookup_inverses

        with tr.span("sumcheck"):
            claimed, challenges = self._co_sumcheck(pub_polys, sh_polys, rp, n, t)
        with tr.span("zeromorph and KZG"):
            self._co_zeromorph(pub_polys, sh_polys, claimed, challenges, n, t)
        return t.proof_data

    # --------------------------------------------------------- co-sumcheck

    def _extend(self, tensor, e0: int, e1: int):
        """Edges [e0, e1) of stacked (L, K, 2E) entities extended to the 8
        evaluation points: (L, K, 8, e1 - e0)."""
        f = self.f
        a = tensor[..., 2 * e0: 2 * e1: 2]
        dd = f.sub(tensor[..., 2 * e0 + 1: 2 * e1: 2], a)
        rows = [a]
        for _ in range(1, BATCHED_LENGTH):
            rows.append(f.add(rows[-1], dd))
        return torch.stack(rows, dim=2)

    def _univariate_map(self, gs, ext_rand, alphas_full):
        """(L, 26, 8, 8) public map of the subrelations' edge sums to the
        round univariate: subrelation k's row i takes its first ln_k sums
        (ln_k its length) to the value at point i (the barycentric
        extension past ln_k), folded with the alpha/pow factors."""
        rows = []
        for si, ln in enumerate(SUBRELATION_LENGTHS):
            key = (ln, BATCHED_LENGTH)
            if key not in _EXT_CACHE:
                _EXT_CACHE[key] = _extension_matrix(ln, BATCHED_LENGTH)
            coefs = [[int(j == i) for j in range(ln)] for i in range(ln)]
            coefs += [list(r) for r in _EXT_CACHE[key]]
            for i in range(BATCHED_LENGTH):
                sc = alphas_full[si]
                if SUBRELATION_IS_LINEARLY_INDEPENDENT[si]:
                    sc = sc * ext_rand[i] % P * gs.partial_evaluation_result % P
                rows += [c * sc % P for c in coefs[i]] + [0] * (BATCHED_LENGTH - ln)
        return self._enc(rows).reshape(self.f.L, len(SUBRELATION_LENGTHS),
                                       BATCHED_LENGTH, BATCHED_LENGTH)

    def _co_sumcheck(self, pub_polys, sh_polys, rp, n, t: Transcript):
        """Round by round: the 26 subrelations over the live edges (in
        chunks of at most EDGE_CHUNK edges), summed over the edges with the
        gate separator's beta products (shares and publics apart), mapped
        to the round univariate by a public matrix, opened; then every
        entity partially evaluated at the challenge.  The entities are
        stacked, (L, K, live) publics and shares, so an extension or a
        partial evaluation is a few tensor ops for all of them."""
        d = self.d
        f = self.f
        alg = self.alg
        log_n = n.bit_length() - 1
        gs = GateSeparator(rp["gate_challenges"], log_n)
        rp_w = {k: alg.pub_of_int(rp[k]) for k in
                ("eta_1", "eta_2", "eta_3", "beta", "gamma",
                 "public_input_delta")}
        alphas_full = [1] + list(rp["alphas"])
        K = len(SUBRELATION_LENGTHS)
        indep = [k for k in range(K) if SUBRELATION_IS_LINEARLY_INDEPENDENT[k]]
        dep = [k for k in range(K) if not SUBRELATION_IS_LINEARLY_INDEPENDENT[k]]

        pub_names = list(pub_polys)
        sh_names = list(sh_polys)
        cur_pub = torch.stack([pub_polys[k] for k in pub_names], dim=1)
        cur_sh = pmap(lambda *cs: torch.stack(cs, dim=1), *(sh_polys[k] for k in sh_names))

        def edge_sums(vals, scal):
            """Each subrelation's (L, 8) sum over the chunk's edges, scaled
            by the beta products where it is linearly independent."""
            zero = d.promote_public(f.zeros((BATCHED_LENGTH,)))
            out = [zero] * K
            for group, sc in ((indep, scal), (dep, None)):
                group = [k for k in group if vals[k] is not None]
                if not group:
                    continue
                x = pmap(lambda *cs: torch.stack(cs, dim=1), *(vals[k] for k in group))
                if sc is not None:
                    x = d.mul_public(x, sc)
                x = pmap(lambda c: f.sum(c, axis=3), x)
                for j, k in enumerate(group):
                    out[k] = pmap(lambda c: c[:, j], x)
            return out

        challenges = []
        per_edge = 0  # shared products a relation evaluation makes an edge
        for round_idx in range(log_n):
            E = cur_pub.shape[-1] // 2
            scal_all = self._enc(gs.beta_products[0: E * gs.periodicity: gs.periodicity])
            sums = None  # (L, K, 8) share of this round's edge sums
            for e0 in range(0, E, EDGE_CHUNK):
                e1 = min(E, e0 + EDGE_CHUNK)
                if per_edge and hasattr(d, "preprocess"):
                    # Shamir: the chunk's double shares in one DN07 batch
                    # instead of one batch a product
                    d.preprocess(per_edge * (e1 - e0))
                before = alg.mul_elems
                xp = self._extend(cur_pub, e0, e1)
                xs = pmap(lambda c: self._extend(c, e0, e1), cur_sh)
                ents = {k: Pub(alg, xp[:, i]) for i, k in enumerate(pub_names)}
                ents.update({k: Sh(alg, pmap(lambda c, i=i: c[:, i], xs))
                             for i, k in enumerate(sh_names)})
                # a family whose public selector is zero on the chunk is
                # skipped (relations.FAMILIES); every party skips alike
                live = [bool((xp[:, pub_names.index(q)] != 0).any()) if q else True
                        for _fn, _k, q in relations.FAMILIES]
                # every family's products of one multiplicative depth as
                # one mul_vec round
                subvals = alg.batched(lambda: [
                    v for (fn, k, _q), on in zip(relations.FAMILIES, live)
                    for v in (fn(ents, rp_w) if on else [None] * k)])
                per_edge = (alg.mul_elems - before) // (e1 - e0)
                del ents, xp, xs
                shape = (f.L, BATCHED_LENGTH, e1 - e0)
                # every subrelation as a share of a full (L, 8, chunk)
                # tensor; a skipped one is zero
                vals = [None if v is None
                        else pmap(lambda c: c.expand(shape), v.v) if isinstance(v, Sh)
                        else d.promote_public(v.v.expand(shape).contiguous())
                        for v in subvals]
                del subvals
                part = edge_sums(vals, scal_all[:, None, None, e0:e1])
                del vals
                part = d.stack_shares(part)  # (L, K, 8)
                sums = part if sums is None else d.add(sums, part)

            pow_cur = gs.current()
            ext_rand = [(1 + k * (pow_cur - 1)) % P for k in range(BATCHED_LENGTH)]
            cmat = self._univariate_map(gs, ext_rand, alphas_full)  # (L, K, 8, 8)
            uni_share = pmap(lambda c: f.sum(f.sum(
                f.mont_mul(cmat, c[:, :, None, :]), axis=3), axis=1), sums)
            univariate = self._open_frs(uni_share)
            t.send_fr_vec("Sumcheck:univariate_%d" % round_idx, univariate)
            u = t.get_challenge("Sumcheck:u_%d" % round_idx)
            challenges.append(u)

            uc = f.const_mont(u)[:, None, None]

            def pe(v):
                a = v[..., 0::2]
                return f.add(a, f.mont_mul(f.sub(v[..., 1::2], a), uc))

            cur_pub = pe(cur_pub)
            cur_sh = pmap(pe, cur_sh)
            gs.partially_evaluate(u)

        zero_univariate = [0] * BATCHED_LENGTH
        for idxr in range(log_n, CONST_PROOF_SIZE_LOG_N):
            t.send_fr_vec("Sumcheck:univariate_%d" % idxr, zero_univariate)
            challenges.append(t.get_challenge("Sumcheck:u_%d" % idxr))

        opened = self._open_frs(pmap(lambda c: c[..., 0], cur_sh))
        pub_vals = [int(v) % P for v in f.decode(cur_pub[..., 0])]
        claimed = dict(zip(sh_names, opened))
        claimed.update(zip(pub_names, pub_vals))
        t.send_fr_vec("Sumcheck:evaluations",
                      [claimed[nm] for nm in ALL_ENTITY_NAMES])
        return claimed, challenges

    # -------------------------------------------------------- co-zeromorph

    def _co_zeromorph(self, pub_polys, sh_polys, claimed, challenges, n,
                      t: Transcript):
        d = self.d
        f = self.f
        log_n = n.bit_length() - 1
        u = challenges

        def sc(v):
            return f.const_mont(v % P)[:, None]

        rho = t.get_challenge("rho")
        batched_eval = 0
        scalar = 1

        def batch(names, claimed_names):
            nonlocal batched_eval, scalar
            pub_acc = torch.zeros_like(pub_polys["q_m"])
            sh_acc = None
            for name, cname in zip(names, claimed_names):
                if name in sh_polys:
                    term = d.mul_public(sh_polys[name], sc(scalar))
                    sh_acc = term if sh_acc is None else d.add(sh_acc, term)
                else:
                    pub_acc = f.add(pub_acc, f.mont_mul(pub_polys[name], sc(scalar)))
                batched_eval = (batched_eval + scalar * claimed[cname]) % P
                scalar = scalar * rho % P
            return d.add_public(sh_acc, pub_acc)

        f_batched = batch(F_NAMES, F_NAMES)
        g_batched = batch(G_NAMES, G_SHIFT_NAMES)

        # f = f_batched + shift(g_batched)
        f_poly = d.add(f_batched, pmap(_shift, g_batched))

        # multilinear quotients (local linear recursion on shares)
        size_q = 1 << (log_n - 1)
        qs = [None] * log_n
        qs[log_n - 1] = d.sub(d.slice_share(f_poly, size_q, 2 * size_q),
                              d.slice_share(f_poly, 0, size_q))
        g_cur = d.slice_share(f_poly, 0, size_q)
        for k in range(1, log_n):
            index = log_n - k
            f_k = d.add(g_cur, d.mul_public(qs[index], sc(u[index])))
            size_q >>= 1
            qs[index - 1] = d.sub(d.slice_share(f_k, size_q, 2 * size_q),
                                  d.slice_share(f_k, 0, size_q))
            g_cur = d.slice_share(f_k, 0, size_q)
        quotients = qs
        del f_poly, g_cur

        # one engine call: every q_k zero-padded to the largest, 2^(log n - 1)
        com_qk = self._commit_open([pmap(lambda c: _place(c, 0, n // 2), qk)
                                    for qk in quotients])
        for idx, pt in enumerate(com_qk):
            t.send_point("ZM:C_q_%d" % idx, pt)
        gen = (self.crs.g1[0].v, self.crs.g1[1].v)
        for idx in range(log_n, CONST_PROOF_SIZE_LOG_N):
            t.send_point("ZM:C_q_%d" % idx, gen)

        y = t.get_challenge("ZM:y")
        # batched lifted-degree quotient: sum_k y^k X^{n - d_k - 1} q_k —
        # known-tau commit only needs its evaluation at tau, but zeta_x
        # needs coefficients, so build it as a padded share
        batched_q = None
        for k, qk in enumerate(quotients):
            deg_k = (1 << k) - 1
            offset = n - deg_k - 1
            term = d.mul_public(qk, sc(pow(y, k, P)))
            padded = pmap(lambda c: _place(c, offset, n), term)
            batched_q = padded if batched_q is None else d.add(batched_q, padded)
        t.send_point("ZM:C_q",
                     self._commit_open([batched_q])[0])

        x, z = t.get_challenges(["ZM:x", "ZM:z"])

        # zeta_x = batched_q - sum_k y^k x^{n-d_k-1} q_k (padded low)
        zeta_x = batched_q
        for k, qk in enumerate(quotients):
            deg_k = (1 << k) - 1
            s = (-(pow(y, k, P) * pow(x, n - deg_k - 1, P))) % P
            term = d.mul_public(qk, sc(s))
            zeta_x = d.add(zeta_x, pmap(lambda c: _place(c, 0, n), term))

        # Z_x = g_batched + x f_batched - v x Phi_n(x) e_0
        #       - x sum_k (x^{2^k} Phi_{n-k-1} - u_k Phi_{n-k}) q_k
        phi_numerator = (pow(x, n, P) - 1) % P
        phi_n_x = phi_numerator * pow(x - 1, -1, P) % P
        z_x = d.add(g_batched, d.mul_public(f_batched, sc(x)))
        del f_batched, g_batched
        v_shift = (-(batched_eval * x % P * phi_n_x)) % P
        e0 = f.zeros((n,))
        e0[:, 0] = f.const_mont(v_shift)
        z_x = d.add_public(z_x, e0)
        for k, qk in enumerate(quotients):
            x_power = pow(x, 1 << k, P)
            phi_1 = phi_numerator * pow(pow(x, 1 << (k + 1), P) - 1, -1, P) % P
            phi_2 = phi_numerator * pow(x_power - 1, -1, P) % P
            s = (-(((x_power * phi_1 - phi_2 * u[k]) % P) * x)) % P
            term = d.mul_public(qk, sc(s))
            z_x = d.add(z_x, pmap(lambda c: _place(c, 0, n), term))

        pi = d.add(zeta_x, d.mul_public(z_x, sc(z)))

        # KZG open: commit((pi - pi(x)) / (X - x)), pi(x) = 0
        with self.tr.span(SPAN_COMMIT):
            t.send_point("KZG:W", self.crs.commit_opening(d, pi, x))
