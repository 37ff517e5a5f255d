#!/usr/bin/env python3
"""End-to-end proof that the PyTorch/CUDA port starts and proves on one GPU.

Run from the repository root with no arguments, on a machine with one
NVIDIA card, nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  build          compile the CUDA kernels from cocircom_tpu_torch/csrc; registers
                 and spill bytes of every instantiation as ptxas reports them
  device         the card's name and power limit as nvidia-smi gives them
  kernels        each kernel against its plain PyTorch version on the card at
                 the shapes the prover gives it, bit for bit (tolerance 0),
                 plus edge inputs; times for kernel and plain version; the
                 least time the card could take (bound); the G1 and G2 adds
                 also at one and two lanes (Horner, the endgame); the G1
                 wave kernels (K5 ec_madd, K6 ec_wave_add) on whole waves of
                 the engine's own prepare of a 2^17-point chunk at c = 12,
                 the first and the last wave, with edge lanes.  Once over
                 BN254 (8 limbs) and once over BLS12-381 (the 12-limb builds
                 over Fq, and the 8-limb NTT kernels with BLS12-381 Fr's
                 constants)
  prove_small    hand-built R1CS -> groth16_setup -> zkey bytes -> loader ->
                 3-party REP3 proof on the card -> pairing verifier accepts,
                 the three proofs are equal, a changed public input is refused
  prove_full     synthetic zkey at 2^20 constraints built on the card, 3-party
                 REP3 proof cold and warm; proofs equal and on curve; the G2
                 waves went through `ec_wave_add_g2`; NTT round trips; one G1
                 and one G2 MSM against a host-computed known discrete log,
                 each wave one launch of its wave kernel (`ec_madd`,
                 `ec_wave_add_g2`)
  prove_sharded  the same zkey and shares, each party's driver built with
                 `devices` = every visible card (the one card twice when
                 there is one), so every prover MSM and (i)NTT goes through
                 the device-sharded engines and the G1 waves through
                 `ec_wave_add`, the G2 waves through `ec_wave_add_g2`;
                 proofs equal and on curve; one sharded G1 and
                 G2 MSM equal to the local engine's and to the known discrete
                 log; a sharded 2^20 NTT and iNTT equal to the local
                 engine's bit for bit
  prove_bls      the hand-built circuit over BLS12-381 through groth16_setup
                 and the loader: a 3-party REP3 proof with one-device
                 drivers and one with sharded drivers; the pairing verifier
                 accepts both and refuses a changed public input; one G1 MSM
                 through each driver's engine, equal, each wave one launch of
                 its 12-limb wave kernel
  graft          graft_entry.entry() and graft_entry.dryrun_multichip(2)
The launch counts are set to 0 just before each phase's first 3-party proof
and read just after it, so they hold the proving paths alone; a line
{"phase": "launches", ...} gives each proof's counts apart.  Then one line
{"kernels": [...]} whose launches are their sum, the nvidia-smi line, and as
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Options (for shorter measurement runs):
  --phases a,b,..   run only these phases (the final ok line is printed only
                    after a full run).  One more phase runs only when named
                    here: `profile`, a warm prove_full-sized proof with
                    one-device drivers and one with sharded drivers under
                    torch.profiler, which prints for each the card's busy
                    share of the wall time and the device time by kernel
  --full-log N      size of prove_full and prove_sharded (default 20; never
                    below 18)

Integer peak used for the bound: the card's table gives 67 TFLOP/s float32
outside the tensor cores, i.e. 33.5e12 fused multiply-adds a second on 128
lanes per SM; 32-bit integer multiply-adds issue on half as many lanes, so
16.75e12 a second.  Memory rate: 3.35e12 bytes a second.  A Montgomery
product of L limbs counts 2*L*L + L multiply-adds, a squaring
L*(L+1)/2 + L*L + L, an Fq2 product 3*L*L + 2*(L*L + L) (Karatsuba, one
reduction a component).  A complete add (RCB16 Alg. 7) is 12 products and
two by b3; where b3 is a small integer (both G1s, BLS12-381's G2) those two
are a few modular adds and count nothing.  The mixed add (madd-2007-bl) is 7
products and 4 squarings.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import torch

MEM_RATE = 3.35e12
INT_MAD_RATE = 16.75e12

SMALL_MULS = 300  # constraints of prove_small's multiplier chain
BLS_MULS = 100    # constraints of prove_bls's multiplier chain

ALL_PHASES = ("build", "device", "kernels", "prove_small", "prove_full", "prove_sharded",
              "prove_bls", "graft")
OPTIONAL_PHASES = ("profile",)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ helpers

def time_cuda(fn, reps: int) -> float:
    """Mean device milliseconds of one call of fn: `reps` calls are captured
    into a CUDA graph and the graph's replay is timed with CUDA events, so
    the host's cost of issuing each launch is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rand_field(f, n_shape, gen: torch.Generator):
    """Uniform canonical Montgomery elements made on the CPU from `gen`."""
    shape = (f.L,) + tuple(n_shape)
    raw = torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64)
    raw[f.L - 1] &= (1 << (f.bits - 32 * (f.L - 1))) - 1
    return f._cond_sub_p(raw.to(torch.int32).to(f.device))


def bound(bytes_moved: float, mads: float):
    tb, to = bytes_moved / MEM_RATE * 1e3, mads / INT_MAD_RATE * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def add_products(ops) -> int:
    """Products of one complete add (RCB16 Alg. 7) over the group of `ops`:
    12, and 2 more where b3 is not a small integer."""
    b3 = ops.b3_host if isinstance(ops.b3_host, tuple) else (ops.b3_host,)
    return 12 if all(c < 256 for c in b3) else 14


def host_tower(curve):
    from cocircom_tpu_torch.pairing.tower import Tower

    t = Tower(curve)
    g1 = (t.fp(curve.g1_gen[0]), t.fp(curve.g1_gen[1]))
    (x0, x1), (y0, y1) = curve.g2_gen
    g2 = (t.fp2(x0, x1), t.fp2(y0, y1))
    return t, g1, g2


def host_mul_g1(curve, k):
    from cocircom_tpu_torch.fields.ec_host import ec_mul

    _, g1, _ = host_tower(curve)
    p = ec_mul(g1, k % curve.fr.p)
    return None if p is None else (p[0].v, p[1].v)


def host_mul_g2(curve, k):
    from cocircom_tpu_torch.fields.ec_host import ec_mul

    _, _, g2 = host_tower(curve)
    p = ec_mul(g2, k % curve.fr.p)
    return None if p is None else ((p[0].c0.v, p[0].c1.v), (p[1].c0.v, p[1].c1.v))


def on_curve(curve, proof) -> bool:
    from cocircom_tpu_torch.fields.ec_host import ec_on_curve

    t, _, _ = host_tower(curve)
    a, b, c = proof["pi_a"], proof["pi_b"], proof["pi_c"]
    if a is None or b is None or c is None:
        return False
    ok = ec_on_curve((t.fp(a[0]), t.fp(a[1])), t.fp(curve.b))
    ok &= ec_on_curve((t.fp(c[0]), t.fp(c[1])), t.fp(curve.b))
    ok &= ec_on_curve((t.fp2(*b[0]), t.fp2(*b[1])), t.fp2(*curve.b2))
    return bool(ok)


def prove_rep3(curve, zkey, shares, device, traced: bool, devices=None):
    """Three party threads over the in-process network; returns
    (proofs, wall seconds, per-span seconds of party 0).  With `devices` the
    parties' drivers are built with that list (the sharded engines)."""
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.snark.groth16 import CoGroth16
    from cocircom_tpu_torch.utils.trace import Tracer

    rows = []

    def party(i, net):
        tracer = Tracer(enabled=traced and i == 0, net=net, sync=torch.cuda.synchronize)
        where = {"device": device} if devices is None else {"devices": devices}
        proof = CoGroth16(Rep3Driver(curve, net, **where), tracer).prove(zkey, shares[i])
        if i == 0:
            rows.extend(tracer.rows)
            rows.append((0, "whole prove (party 0, incl. PRF setup)", 0.0, *net.stats()))
        return proof

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proofs = run_parties(party, 3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = {name: {"s": round(dt, 3), "sent_bytes": sent, "recv_bytes": recvd}
             for _, name, dt, sent, recvd in rows}
    return proofs, wall, spans


# ------------------------------------------------------------ phase: kernels

def phase_kernels(curve, device) -> list:
    """Every kernel against its plain version at the main path's shapes, over
    `curve`.  The curve kernels (K4, K5, K6, G2 add) run over its Fq.  The
    field kernels (K1, K2, K3) run over Fr for BN254, as the prover gives
    them, and over the 12-limb Fq for BLS12-381, with a power table of an
    arbitrary element as twiddles (Fq has no large root of unity; kernel and
    plain version run the same butterfly network on whatever table they are
    given); there the 8-limb K2 and K3 are also held to their plain versions
    with BLS12-381 Fr's constants and real twiddles.

    Rows are named by the launch count's key: the kernel's name for 8 limbs,
    `<name>_l12` for 12."""
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.curve import (ProjPoint, add_wave_lanes, add_wave_plain,
                                              ec_add_g2_plain, ec_add_plain, ec_madd,
                                              ec_wave_add, ec_wave_add_g2, ec_wave_add_g2_plain,
                                              g1_ops, g2_ops, leaves, madd_wave_plain, pmap)
    from cocircom_tpu_torch.ops.field import get_field, mont_mul_plain
    from cocircom_tpu_torch.ops.msm import MSM
    from cocircom_tpu_torch.ops.ntt import (butterfly, butterfly_plain, ntt_columns,
                                            ntt_columns_plain, ntt_engine, power_table)

    gen = torch.Generator().manual_seed(20)
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    fq = get_field(curve.fq.p, curve.name + ".fq", device)
    g1 = g1_ops(curve, device)
    L = fq.L
    f1 = fr if L == 8 else fq            # the field K1-K3 are timed over
    mpm = 2 * L * L + L                  # multiply-adds of one Montgomery product
    msq = L * (L + 1) // 2 + L * L + L   # of one Montgomery squaring
    add_mads = add_products(g1) * mpm    # of one complete G1 add
    W = 4 * L                            # bytes of one element
    out = []

    def edge(f, n):
        """n elements cycling through 0, 1, p-1, R mod p, 2."""
        vals = [0, 1, f.p - 1, 1, 2]
        return f.encode([vals[i % len(vals)] for i in range(n)])

    def timed_plain(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def record(name, source, replaces, err, ms, plain_ms, nbytes, mads, shape, per_launch=None,
               **extra):
        """per_launch: [(bytes, multiply-adds)] of each of several launches
        that `ms` is the mean of; the bound is then their mean."""
        if per_launch:
            b_ms = sum(bound(*x)[0] for x in per_launch) / len(per_launch)
            by = bound(sum(x[0] for x in per_launch), sum(x[1] for x in per_launch))[1]
        else:
            b_ms, by = bound(nbytes, mads)
        out.append({
            "name": kernels.count_key(name, L), "route": "cuda",
            "source": f"cocircom_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "shape": shape, **extra,
        })

    def max_err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    def twiddles(f, logm, inverse=False):
        """w^0..w^(M/2-1): the engine's table over Fr, powers of 7 over Fq."""
        if f is fr:
            return ntt_engine(fr, curve.fr)._twiddles(logm, inverse)
        return power_table(f, 7, max((1 << logm) // 2, 1)).contiguous()

    # ---- K1 mont_mul: (L, 2^20) x (L, 2^20) (coset shift, mul_vec) ----
    n = 1 << 20
    a = rand_field(f1, (n,), gen)
    b = rand_field(f1, (n,), gen)
    a[:, :64] = edge(f1, 64)
    b[:, :64] = edge(f1, 64).roll(1, dims=1)
    got = f1.mont_mul(a, b)
    err = max_err(got, mont_mul_plain(f1, a, b))
    single = b[:, :1].contiguous()
    err = max(err, max_err(f1.mont_mul(a, single), mont_mul_plain(f1, a, single)))
    for f in (fr, fq):                   # both fields of the curve, edge values
        qa, qb = edge(f, 4096), rand_field(f, (4096,), gen)
        err = max(err, max_err(f.mont_mul(qa, qb), mont_mul_plain(f, qa, qb)))
    check(err == 0, f"mont_mul (L={L}) disagrees with mont_mul_plain (max abs err {err})")
    ms = time_cuda(lambda: f1.mont_mul(a, b), 50)
    pms = timed_plain(lambda: mont_mul_plain(f1, a, b))
    record("mont_mul", "mont_mul.cu", "cocircom_tpu/ops/pallas_field.py:593", err, ms, pms,
           3 * W * n, mpm * n, [L, n])

    # ---- K2 ntt_butterfly: (L, 1024): a stage of the 2^11-point transform,
    # the largest the per-stage engine runs ----
    def check_butterfly(f):
        n = 1 << 10
        e, o, w = (rand_field(f, (n,), gen) for _ in range(3))
        e[:, :64] = edge(f, 64)
        o[:, :64] = edge(f, 64).roll(2, dims=1)
        w[:, :64] = edge(f, 64).roll(1, dims=1)
        ge, go = butterfly(f, e, o, w)
        pe, po = butterfly_plain(f, e, o, w)
        err = max(max_err(ge, pe), max_err(go, po))
        big = [rand_field(f, (1 << 16,), gen) for _ in range(3)]
        g2_, p2_ = butterfly(f, *big), butterfly_plain(f, *big)
        return max(err, max_err(g2_[0], p2_[0]), max_err(g2_[1], p2_[1])), (e, o, w)

    err, (e, o, w) = check_butterfly(f1)
    check(err == 0, f"ntt_butterfly (L={L}) disagrees with butterfly_plain (max abs err {err})")
    n = 1 << 10
    ms = time_cuda(lambda: butterfly(f1, e, o, w), 200)
    pms = timed_plain(lambda: butterfly_plain(f1, e, o, w))
    record("ntt_butterfly", "ntt_butterfly.cu", "cocircom_tpu/ops/pallas_field.py:502", err,
           ms, pms, 5 * W * n, mpm * n, [L, n])

    # ---- K3 ntt_columns: (L, 1024, 1024): the first level of a 2^20 NTT ----
    def check_columns(f, shapes):
        err = 0
        for logm, cols in shapes:
            xs = rand_field(f, (1 << logm, cols), gen)
            tws = twiddles(f, logm, True)
            err = max(err, max_err(ntt_columns(f, xs, tws), ntt_columns_plain(f, xs, tws)))
        return err

    M, B = 1 << 10, 1 << 10
    tw = twiddles(f1, 10)
    x = rand_field(f1, (M, B), gen)
    x[:, :8, :8] = edge(f1, 64).reshape(L, 8, 8)
    got = ntt_columns(f1, x, tw)
    err = max_err(got, ntt_columns_plain(f1, x, tw))
    err = max(err, check_columns(f1, ((1, 5), (4, 3), (9, 64), (10, 64))))
    check(err == 0, f"ntt_columns (L={L}) disagrees with ntt_columns_plain (max abs err {err})")
    ms = time_cuda(lambda: ntt_columns(f1, x, tw), 10)
    pms = timed_plain(lambda: ntt_columns_plain(f1, x, tw))
    record("ntt_columns", "ntt_columns.cu", "cocircom_tpu/ops/pallas_ntt.py:223", err, ms, pms,
           2 * W * M * B + W * (M // 2), 10 * (M // 2) * B * mpm, [L, M, B])
    del x, got

    if f1 is not fr:
        # this curve's Fr: the 8-limb builds with another modulus and root tower
        err = max(check_butterfly(fr)[0], check_columns(fr, ((4, 3), (10, 64))))
        check(err == 0, f"{curve.name} Fr: an NTT kernel disagrees with its plain version")

    # ---- K4 ec_add: (L, 22, 2048): the bucket-reduction suffix sums of a
    # c = 12 MSM ----
    nl = 22 * 2048
    small = torch.randint(1, 1 << 15, (1, nl), generator=gen, dtype=torch.int64)
    base = g1.encode_points([curve.g1_gen])
    P = g1.scalar_mul(base, small.to(torch.int32).to(device), nbits=15)
    Q = ProjPoint(*(c.roll(1, dims=1) for c in P))
    ident = g1.identity((16,))
    for i, c in enumerate(P):          # identity on the left, then P + P, P + (-P)
        c[:, :16] = ident[i]
    negP = g1.neg(P)
    for i, c in enumerate(Q):
        c[:, 32:48] = P[i][:, 32:48]
        c[:, 48:64] = negP[i][:, 48:64]
        c[:, 64:80] = ident[i]
    got = g1.add(P, Q)
    ref = ec_add_plain(fq, g1._b3_mont, P, Q)
    err = max(max_err(g, r) for g, r in zip(got, ref))
    one = ProjPoint(*(c[:, 100].contiguous() for c in P))
    got1, ref1 = g1.add(P, one), ec_add_plain(fq, g1._b3_mont, P, one)
    err = max(err, max(max_err(g, r) for g, r in zip(got1, ref1)))
    check(err == 0, f"ec_add (L={L}) disagrees with ec_add_plain (max abs err {err})")
    dec = g1.decode_points(ProjPoint(*(c[:, 40:56] for c in got)))
    check(all(d is None for d in dec[8:]), "ec_add: P + (-P) is not the identity")
    few = {}
    for k in (1, 2):                     # Horner's and the endgame's lane counts
        Pk, Qk = (ProjPoint(*(c[:, 100:100 + k].contiguous() for c in X)) for X in (P, Q))
        gk, rk = g1.add(Pk, Qk), ec_add_plain(fq, g1._b3_mont, Pk, Qk)
        err = max(err, max(max_err(g, r) for g, r in zip(gk, rk)))
        few[k] = time_cuda(lambda: g1.add(Pk, Qk), 200)
    check(err == 0, f"ec_add (L={L}) disagrees with ec_add_plain at 1-2 lanes (max abs err {err})")
    ms = time_cuda(lambda: g1.add(P, Q), 50)
    pms = timed_plain(lambda: ec_add_plain(fq, g1._b3_mont, P, Q))
    record("ec_add", "ec_add.cu", "cocircom_tpu/ops/pallas_curve.py:225", err, ms, pms,
           9 * W * nl, add_mads * nl, [L, 22, 2048], ms_1_lane=few[1], ms_2_lanes=few[2],
           bound_ms_1_lane=bound(9 * W, add_mads)[0])

    # ---- K5 ec_madd and K6 ec_wave_add: whole waves of a c = 12 MSM over one
    # 2^17-point chunk, (L, 22, 2049, 8) lanes, from the engine's own prepare
    # of random scalars; the first and the last wave held to the plain
    # version, every wave of the chunk timed in turn (ms is the mean a
    # launch, as the path gives it) ----
    cw, npt = 12, 1 << 17
    nbits = curve.fr.bits
    wave = (-(-(nbits + 1) // cw), (1 << (cw - 1)) + 1, 8)    # (22, 2049, 8)
    nl = wave[0] * wave[1] * wave[2]
    eng = MSM(g1, c=cw, t=8, scalar_bits=nbits)
    scal = rand_field(fr, (npt,), gen)
    small = torch.randint(1, 1 << 15, (1, npt), generator=gen, dtype=torch.int64)
    pts = g1.scalar_mul(base, small.to(torch.int32).to(device), nbits=15)
    proj = g1.add(pts, ProjPoint(*(c.roll(3, dims=1) for c in pts)))   # z != 1
    spread = (torch.arange(nl, device=device) * 7 + 3) % npt

    def lanes_of(t):
        return t.reshape((L,) + wave).contiguous()

    def check_waves(name, run, plain, acc0, waves, masks):
        """Kernel against plain version on waves `waves` from acc0; masked
        lanes untouched.  Returns the largest error."""
        err = 0
        for w in waves:
            acc = ProjPoint(*(c.clone() for c in acc0))
            got, ref = run(acc, w), plain(acc0, w)
            err = max(err, max(max_err(g, r) for g, r in zip(got, ref)))
            keep = ~masks(w)
            check(all(torch.equal(g.reshape(L, -1)[:, keep], a.reshape(L, -1)[:, keep])
                      for g, a in zip(got, acc0)), f"{name}: a masked lane changed")
        check(err == 0, f"{name} (L={L}) disagrees with its plain version (max abs err {err})")
        return err, got

    def time_chunk(run, acc0, n_super, reps):
        """Mean ms a launch over every wave of the chunk, in order."""
        acc = ProjPoint(*(c.clone() for c in acc0))
        return time_cuda(lambda: [run(acc, w) for w in range(n_super)], reps) / n_super

    def time_chunk_plain(plain, acc0, n_super):
        """Mean ms a wave of the plain version over the same waves, in order
        (check_waves ran it before, so nothing is built here)."""
        acc = acc0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in range(n_super):
            acc = plain(acc, w)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_super

    # K5: the run-aligned signed affine table, (0, 0) rows for a few points
    scatter_idx, astart, aend, n_waves = eng._prepare_madd(scal, nbits, cw)
    rows2 = eng._affine_em(pts)
    zero_pts = torch.arange(40, 48, device=device)
    rows2[zero_pts] = 0
    rows2[zero_pts + npt] = 0
    table = eng._table_rows(rows2, scatter_idx)
    m_tab = scatter_idx.shape[1]
    n_super = -(-int(n_waves.item()) // 8)
    kp1 = torch.arange(wave[1], device=device)[None, :, None]

    def madd_lanes(w):
        """(valid, valid with a row other than (0, 0), row index) of wave w's lanes."""
        pos = astart[:, :, None] + w * 8 + torch.arange(8, device=device)
        valid = ((pos < aend[:, :, None]) & (kp1 > 0)).reshape(-1)
        rowi = (pos + (torch.arange(wave[0], device=device) * m_tab)[:, None, None]).reshape(-1)
        rowi = rowi.clamp(max=table.shape[0] - 1)
        nonzero = (table[rowi] != 0).any(dim=1)
        return valid, valid & nonzero, rowi

    # Jacobian accumulators with random Z (X = x Z^2, Y = y Z^3); in the
    # first wave 16 live lanes hold the point they add (doubling) and 16 its
    # inverse
    ax, ay = g1.to_affine_limbs(ProjPoint(*(c[:, spread] for c in proj)))
    _, live, rowi = madd_lanes(0)
    live = live.nonzero().flatten()[:32]
    ax[:, live] = table[rowi[live], :L].t()
    ay[:, live] = table[rowi[live], L:].t()
    ay[:, live[16:]] = fq.neg(ay[:, live[16:]])
    z = rand_field(fq, (nl,), gen)
    zz = fq.mont_mul(z, z)
    acc0 = ProjPoint(lanes_of(fq.mont_mul(ax, zz)), lanes_of(fq.mont_mul(ay, fq.mont_mul(zz, z))),
                     lanes_of(z))

    run5 = lambda acc, w: ec_madd(fq, acc, table, astart, aend, w)  # noqa: E731
    plain5 = lambda acc, w: madd_wave_plain(fq, acc, table, astart, aend, w)  # noqa: E731
    err, _ = check_waves("ec_madd", run5, plain5, acc0, (0, n_super - 1),
                         lambda w: madd_lanes(w)[1])
    zero_taken = sum(int((v & ~lv).sum()) for v, lv, _ in map(madd_lanes, range(n_super)))
    check(zero_taken > 0, "ec_madd: no lane met a (0, 0) row")
    live5 = [[int(m.sum()) for m in madd_lanes(w)[:2]] for w in range(n_super)]
    ms = time_chunk(run5, acc0, n_super, 4)
    pms = time_chunk_plain(plain5, acc0, n_super)
    record("ec_madd", "ec_madd.cu", "cocircom_tpu/ops/pallas_curve.py:507", err, ms, pms, 0, 0,
           [L, *wave], waves=n_super, live_share=sum(lv for _, lv in live5) / (nl * n_super),
           per_launch=[(16 * wave[0] * wave[1] + 2 * W * v + 6 * W * lv, (7 * mpm + 4 * msq) * lv)
                       for v, lv in live5])
    del table, rows2, scatter_idx, acc0, z, zz

    # K6: the complete-add prepare over projective points with generic z;
    # edge lanes in the first wave: identity accumulators, doubling, inverse
    # points, identity points and all-zero rows negated
    digits, order, sortedb, bstart, n_waves = eng._prepare(scal, nbits, cw)
    n_super = -(-int(n_waves.item()) // 8)
    pts_em = eng._emajor(proj)
    src, neg, valid = add_wave_lanes(order, sortedb, digits, bstart, 0, 8)
    live = valid.nonzero().flatten()
    ident = g1.identity((1,))
    pts_em[src[live[64:80]]] = torch.cat(list(ident), dim=0).t()       # identity points
    nz = live[neg[live]][40:56]
    pts_em[src[nz]] = 0                                                # zero rows, negated
    acc0 = [c[:, spread].clone() for c in proj]
    x2, y2, z2 = (pts_em[src[live[:48]], k * L:(k + 1) * L].t() for k in range(3))
    y2 = torch.where(neg[live[:48]][None], fq.neg(y2), y2)            # what each lane adds
    for i, c in enumerate(ident):
        acc0[i][:, live[:16]] = c                                      # identity accumulator
    acc0[0][:, live[16:48]] = x2[:, 16:]
    acc0[2][:, live[16:48]] = z2[:, 16:]
    acc0[1][:, live[16:32]] = y2[:, 16:32]                             # doubling
    acc0[1][:, live[32:48]] = fq.neg(y2[:, 32:48])                     # inverse point
    acc0 = ProjPoint(*(lanes_of(c) for c in acc0))

    def add_lanes(w):
        return add_wave_lanes(order, sortedb, digits, bstart, w, 8)[2]

    run6 = lambda acc, w: ec_wave_add(g1, acc, pts_em, order, sortedb, digits, bstart, w)  # noqa: E731
    plain6 = lambda acc, w: add_wave_plain(g1, acc, pts_em, order, sortedb, digits, bstart, w)  # noqa: E731
    err, got = check_waves("ec_wave_add", run6, plain6, acc0, (n_super - 1, 0), add_lanes)
    flat = ProjPoint(*(c.reshape(L, -1)[:, live[:48]] for c in got))
    dec = g1.decode_points(flat)
    want = g1.decode_points(ProjPoint(x2[:, :16], y2[:, :16], z2[:, :16]))
    check(dec[:16] == want, "ec_wave_add: identity + P is not P")
    dbl = g1.decode_points(g1.double(ProjPoint(x2[:, 16:32], y2[:, 16:32], z2[:, 16:32])))
    check(dec[16:32] == dbl, "ec_wave_add: P + P is not 2P")
    check(all(d is None for d in dec[32:48]), "ec_wave_add: P + (-P) is not the identity")
    pos = bstart[:, :, None] + (n_super - 1) * 8 + torch.arange(8, device=device)
    check(bool((pos >= npt).any()), "ec_wave_add: no lane of the last wave was clamped")
    work6 = []                     # (bytes, multiply-adds) of each wave
    for w in range(n_super):
        pos = bstart[:, :, None] + w * 8 + torch.arange(8, device=device)
        asked = int(((pos < npt) & (kp1 > 0)).sum())       # lanes that read sortedb
        v = int(add_lanes(w).sum())
        work6.append((8 * wave[0] * wave[1] + 8 * asked + (16 + 9 * W) * v, add_mads * v))
    ms = time_chunk(run6, acc0, n_super, 4)
    pms = time_chunk_plain(plain6, acc0, n_super)
    record("ec_wave_add", "ec_wave_add.cu", "cocircom_tpu/ops/pallas_curve.py:256", err, ms, pms,
           0, 0, [L, *wave], waves=n_super,
           live_share=sum(int(add_lanes(w).sum()) for w in range(n_super)) / (nl * n_super),
           per_launch=work6)
    del proj, pts, pts_em, acc0, got, digits, order, sortedb, scal

    # ---- ec_add_g2: (L, 22, 2049, 8) lanes over Fq2: one wave of a c = 12
    # G2 MSM.  The plain version stacks 18 base products per lane in int64
    # columns, so it runs over slices of the lane axis (2 windows each) ----
    g2 = g2_ops(curve, device)
    add2_mads = add_products(g2) * (3 * L * L + 2 * (L * L + L))     # of one G2 add
    small = torch.randint(1, 1 << 15, (1, nl), generator=gen, dtype=torch.int64)
    P2 = g2.scalar_mul(g2.encode_points([curve.g2_gen]),
                       small.to(torch.int32).to(device), nbits=15)
    Q2 = ProjPoint(*((c[0].roll(1, dims=1), c[1].roll(1, dims=1)) for c in P2))
    ident2 = g2.identity((16,))
    neg2 = g2.neg(P2)
    for i in range(3):
        for j in range(2):
            P2[i][j][:, :16] = ident2[i][j]            # identity + Q
            Q2[i][j][:, 32:48] = P2[i][j][:, 32:48]     # P + P
            Q2[i][j][:, 48:64] = neg2[i][j][:, 48:64]   # P + (-P)
            Q2[i][j][:, 64:80] = ident2[i][j]           # P + identity
    piece = 2 * 2049 * 8

    def g2_plain(P, Q):
        """ec_add_g2_plain slice by slice; a single point Q goes to every slice."""
        parts = [ec_add_g2_plain(
            g2, pmap(lambda c: c[:, lo:lo + piece], P),
            Q if Q.x[0].dim() == 1 else pmap(lambda c: c[:, lo:lo + piece], Q))
            for lo in range(0, nl, piece)]
        return pmap(lambda *cs: torch.cat(cs, dim=1), *parts)

    got = g2.add(P2, Q2)
    ref = g2_plain(P2, Q2)
    err = max(max_err(g, r) for g, r in zip(leaves(got), leaves(ref)))
    one2 = ProjPoint(*((c[0][:, 100].contiguous(), c[1][:, 100].contiguous()) for c in P2))
    err = max(err, max(max_err(g, r) for g, r in zip(leaves(g2.add(P2, one2)),
                                                     leaves(g2_plain(P2, one2)))))
    check(err == 0, f"ec_add_g2 (L={L}) disagrees with ec_add_g2_plain (max abs err {err})")
    dec = g2.decode_points(ProjPoint(*((c[0][:, 48:56], c[1][:, 48:56]) for c in got)))
    check(all(d is None for d in dec), "ec_add_g2: P + (-P) is not the identity")
    few = {}
    for k in (1, 2):
        Pk, Qk = (pmap(lambda c: c[:, 100:100 + k].contiguous(), X) for X in (P2, Q2))
        gk, rk = g2.add(Pk, Qk), ec_add_g2_plain(g2, Pk, Qk)
        err = max(err, max(max_err(g, r) for g, r in zip(leaves(gk), leaves(rk))))
        few[k] = time_cuda(lambda: g2.add(Pk, Qk), 200)
    check(err == 0, f"ec_add_g2 (L={L}) disagrees with ec_add_g2_plain at 1-2 lanes")
    ms = time_cuda(lambda: g2.add(P2, Q2), 20)
    pms = timed_plain(lambda: g2_plain(P2, Q2))
    record("ec_add_g2", "ec_add_g2.cu", "cocircom_tpu/ops/curve.py:223", err, ms, pms,
           18 * W * nl, add2_mads * nl, [L, *wave], ms_1_lane=few[1], ms_2_lanes=few[2],
           bound_ms_1_lane=bound(18 * W, add2_mads)[0])

    # ---- ec_wave_add_g2: (L, 22, 2049, 8) lanes over Fq2: one G2 wave of a
    # c = 12 MSM, 80% valid, half negated; accumulators and points projective
    # with generic z, edge lanes as for K6 ----
    proj2 = g2.add(P2, pmap(lambda c: c.roll(3, dims=1), P2))          # z != 1
    del P2, Q2, got, ref
    acc0 = pmap(lambda c: c.roll(11, dims=1).contiguous(), proj2)
    rows6 = torch.cat(leaves(proj2), dim=0).t().contiguous()           # (nl, 6L)
    valid = torch.rand(nl, generator=gen).to(device) < 0.8
    neg = torch.rand(nl, generator=gen).to(device) < 0.5
    acc_rows = torch.cat(leaves(acc0), dim=0).t()
    for c, i in zip(leaves(acc0), leaves(ident2)):
        c[:, :16] = i                                                  # identity accumulator
    rows6[16:32] = torch.cat(leaves(ident2), dim=0).t()                # identity point
    rows6[32:64] = acc_rows[32:64]                                     # doubling, inverse point
    neg[32:48], neg[48:64] = False, True
    valid[:64], neg[:16] = True, False
    rows6[64:80] = 0                                                   # masked, all-zero rows
    valid[64:80], neg[64:80] = False, True
    valid[96:160] = False                                              # masked whole warps
    acc0 = pmap(lambda c: c.reshape((L,) + wave).contiguous(), acc0)

    def wave_plain(acc_in):
        """ec_wave_add_g2_plain slice by slice (lanes are independent)."""
        flat = pmap(lambda c: c.reshape(L, -1), acc_in)
        parts = [ec_wave_add_g2_plain(g2, pmap(lambda c: c[:, lo:lo + piece], flat),
                                      rows6[lo:lo + piece], neg[lo:lo + piece],
                                      valid[lo:lo + piece])
                 for lo in range(0, nl, piece)]
        return pmap(lambda *cs: torch.cat(cs, dim=1).reshape((L,) + wave), *parts)

    ref = wave_plain(acc0)
    acc = pmap(lambda c: c.clone(), acc0)
    got = ec_wave_add_g2(g2, acc, rows6, neg, valid)
    err = max(max_err(g, r) for g, r in zip(leaves(got), leaves(ref)))
    check(err == 0, f"ec_wave_add_g2 (L={L}) disagrees with ec_wave_add_g2_plain "
          f"(max abs err {err})")
    check(all(torch.equal(g.reshape(L, -1)[:, ~valid], a.reshape(L, -1)[:, ~valid])
              for g, a in zip(leaves(got), leaves(acc0))), "ec_wave_add_g2: a masked lane changed")
    flat = pmap(lambda c: c.reshape(L, -1)[:, :64], got)
    dec = g2.decode_points(flat)
    check(dec[:16] == g2.decode_points(pmap(lambda c: c[:, :16], proj2)),
          "ec_wave_add_g2: identity + P is not P")
    check(dec[16:32] == g2.decode_points(pmap(lambda c: c.reshape(L, -1)[:, 16:32], acc0)),
          "ec_wave_add_g2: P + identity is not P")
    dbl = g2.decode_points(g2.double(pmap(lambda c: c.reshape(L, -1)[:, 32:48].contiguous(),
                                          acc0)))
    check(dec[32:48] == dbl, "ec_wave_add_g2: P + P is not 2P")
    check(all(d is None for d in dec[48:64]), "ec_wave_add_g2: P + (-P) is not the identity")
    n_valid = int(valid.sum().item())
    ms = time_cuda(lambda: ec_wave_add_g2(g2, acc, rows6, neg, valid), 20)
    pms = timed_plain(lambda: wave_plain(acc0))
    record("ec_wave_add_g2", "ec_wave_add_g2.cu", "cocircom_tpu/ops/msm.py:350", err, ms, pms,
           nl + (1 + 18 * W) * n_valid, add2_mads * n_valid, [L, *wave])
    del proj2, acc0, acc, rows6, got, ref

    emit({"phase": "kernels", "curve": curve.name, "limbs": L,
          "kernels": [k["name"] for k in out], "tolerance": 0,
          "detail": [{k: v for k, v in r.items() if k in
                      ("name", "ms", "plain_ms", "bound_ms", "bound_by", "shape")}
                     for r in out],
          "launches_during_checks": kernels.launch_counts()})
    return out


# -------------------------------------------------------- phase: prove_small

def phase_prove_small(curve, device, n_mul: int) -> dict:
    """Returns the launch counts of the 3-party proof alone."""
    from cocircom_tpu_torch.ops import kernels

    zkey, vk, shares, publics, setup_s = small_inputs(curve, device, n_mul, b"chip_smoke")
    kernels.reset_launch_counts()
    proofs, wall, _ = prove_rep3(curve, zkey, shares, device, traced=False)
    counts = kernels.launch_counts()
    check_small_proofs("prove_small", vk, proofs, publics)
    emit({"phase": "prove_small", "constraints": n_mul,
          "domain": zkey.domain_size, "setup_s": round(setup_s, 2),
          "prove_s": round(wall, 3), "verified": True, "tamper_rejected": True})
    return counts


def small_inputs(curve, device, n_mul: int, seed: bytes):
    """The hand-built multiplier chain over `curve` through the real setup
    and the real loader: (zkey, vk, the parties' shares, publics, seconds the
    host-side setup took)."""
    from cocircom_tpu_torch.io.r1cs import multiplier_chain
    from cocircom_tpu_torch.io.witness import Witness
    from cocircom_tpu_torch.io.zkey import read_groth16_zkey
    from cocircom_tpu_torch.ops.field import ints_to_limbs_np
    from cocircom_tpu_torch.snark.setup import groth16_setup
    from cocircom_tpu_torch.snark.shared import split_witness_rep3

    t0 = time.perf_counter()
    r1cs, vals = multiplier_chain(curve, n_mul, 3)
    zkey_bytes, vk = groth16_setup(r1cs, seed=seed)
    setup_s = time.perf_counter() - t0
    zkey = read_groth16_zkey(zkey_bytes, device=device)
    check(zkey.curve is curve, "the loader did not find the zkey's curve")
    wit = Witness(curve, len(vals), ints_to_limbs_np(vals, -(-curve.fr.bits // 32)))
    shares = split_witness_rep3(wit, 2, seed=7, device=device)
    return zkey, vk, shares, [vals[1], vals[2]], setup_s


def check_small_proofs(phase: str, vk, proofs, publics) -> None:
    from cocircom_tpu_torch.snark.groth16_verify import verify_groth16

    check(proofs[0] == proofs[1] == proofs[2], f"{phase}: the parties' proofs differ")
    check(verify_groth16(vk, proofs[0], publics), f"{phase}: the verifier refused the proof")
    check(not verify_groth16(vk, proofs[0], [publics[0], publics[1] + 1]),
          f"{phase}: the verifier accepted a changed public input")


# --------------------------------------------------------- phase: prove_full

def synthetic_zkey(curve, log_n: int, device, seed: int):
    """The zkey of a synthetic circuit at 2^log_n constraints, built on the
    device: n_vars = domain = 2^log_n, nc = domain - 10, one term per row in
    A and B, every query point a known 15-bit odd multiple of the generator.
    Returns (zkey, multipliers of a_query and of b_g2_query as numpy)."""
    from types import SimpleNamespace

    from cocircom_tpu_torch.io.zkey import G1Array, G2Array
    from cocircom_tpu_torch.ops.curve import g1_ops, g2_ops
    from cocircom_tpu_torch.ops.field import get_field

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    g1, g2 = g1_ops(curve, device), g2_ops(curve, device)
    n_vars = domain = 1 << log_n
    n_public = 1
    nc = domain - 10
    wlen = n_vars - 1 - n_public
    gen = torch.Generator().manual_seed(seed)

    def multipliers(n):
        return (torch.randint(0, 1 << 15, (n,), generator=gen, dtype=torch.int64) | 1)

    def gen_g1(n):
        k = multipliers(n)
        base = g1.encode_points([curve.g1_gen])
        pts = g1.scalar_mul(base, k[None].to(torch.int32).to(device), nbits=15)
        ax, ay = g1.to_affine_limbs(pts)
        return G1Array(ax, ay), k.numpy()

    def gen_g2(n, piece=1 << 17):
        k = multipliers(n)
        base = g2.encode_points([curve.g2_gen])
        parts = []
        for lo in range(0, n, piece):       # bounded working set
            pts = g2.scalar_mul(base, k[None, lo:lo + piece].to(torch.int32).to(device),
                                nbits=15)
            parts.append(g2.to_affine_limbs(pts))
        cat = lambda sel: torch.cat([sel(p) for p in parts], dim=1)  # noqa: E731
        return G2Array(cat(lambda p: p[0][0]), cat(lambda p: p[0][1]),
                       cat(lambda p: p[1][0]), cat(lambda p: p[1][1])), k.numpy()

    a_query, k_a = gen_g1(n_vars)
    b_g1_query, _ = gen_g1(n_vars)
    l_query, _ = gen_g1(wlen)
    h_query, _ = gen_g1(domain)
    b_g2_query, k_b2 = gen_g2(n_vars)

    rows = torch.arange(nc, dtype=torch.int64, device=device)
    coeffs = fr.one_mont((nc,)).contiguous()
    mats = SimpleNamespace(
        num_constraints=nc, num_instance=n_public + 1,
        a_rows=rows, a_cols=(rows * 7 + 1) % n_vars, a_coeffs=coeffs,
        b_rows=rows, b_cols=(rows * 13 + 3) % n_vars, b_coeffs=coeffs)
    zkey = SimpleNamespace(
        curve=curve, n_vars=n_vars, n_public=n_public, domain_size=domain, pow=log_n,
        alpha_g1=host_mul_g1(curve, 3), beta_g1=host_mul_g1(curve, 5),
        beta_g2=host_mul_g2(curve, 5), gamma_g2=host_mul_g2(curve, 7),
        delta_g1=host_mul_g1(curve, 11), delta_g2=host_mul_g2(curve, 11),
        ic=None, a_query=a_query, b_g1_query=b_g1_query, b_g2_query=b_g2_query,
        l_query=l_query, h_query=h_query, matrices=mats)
    return zkey, k_a, k_b2


def full_inputs(curve, device, log_n: int, gen: torch.Generator):
    """The synthetic zkey and the three parties' shares of a random witness:
    (zkey, k_a, k_b2, shares, seconds the zkey took to build)."""
    from cocircom_tpu_torch.mpc.rep3 import share_field_vec
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.snark.groth16 import SharedWitness

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    t0 = time.perf_counter()
    zkey, k_a, k_b2 = synthetic_zkey(curve, log_n, device, seed=42)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    wit = fr.to_mont(rand_field(fr, (zkey.n_vars - 2,), gen))
    shares = [SharedWitness([1, 12345], s) for s in share_field_vec(fr, wit, seed=4242)]
    return zkey, k_a, k_b2, shares, build_s


def phase_prove_full(curve, device, log_n: int, inputs) -> dict:
    """Returns the launch counts of the cold 3-party proof alone."""
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.curve import pmap
    from cocircom_tpu_torch.ops.field import get_field

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    gen = torch.Generator().manual_seed(4343)
    zkey, k_a, k_b2, shares, build_s = inputs

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    proofs, cold, spans_cold = prove_rep3(curve, zkey, shares, device, traced=True)
    counts_cold = kernels.launch_counts()
    proofs_w, warm, spans_warm = prove_rep3(curve, zkey, shares, device, traced=True)
    peak = torch.cuda.max_memory_allocated()
    check(proofs[0] == proofs[1] == proofs[2], "prove_full: the parties' proofs differ")
    check(proofs_w[0] == proofs_w[1] == proofs_w[2], "prove_full: warm proofs differ")
    check(on_curve(curve, proofs[0]) and on_curve(curve, proofs_w[0]),
          "prove_full: a proof point is not on its curve")
    check(counts_cold["ec_wave_add_g2"] > 0, "prove_full: ec_wave_add_g2 was never launched")

    # NTT round trip at the size the witness map uses
    d = PlainDriver(curve, device=device)
    x = rand_field(fr, (zkey.domain_size,), gen)
    check(torch.equal(d.ntt.intt(d.ntt.ntt(x)), x), "prove_full: intt(ntt(x)) != x")

    # one G1 and one G2 MSM against the known discrete log
    s_std = rand_field(fr, (zkey.n_vars,), gen)
    for name, (eng, ops, arr, want) in msm_cases(curve, d, zkey, k_a, k_b2, fr, s_std).items():
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        res = eng.msm(arr, s_std)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        c = kernels.launch_counts()
        got = ops.decode_points(pmap(lambda c: c[:, None], res))[0]
        check(got == want, f"prove_full: MSM {name} != (sum k_i s_i) G")
        wave_kernel = "ec_madd" if name == "g1" else "ec_wave_add_g2"
        check(c[wave_kernel] == eng.last_waves > 0 and c["ec_wave_add"] == 0,
              f"prove_full: the {name} MSM did not run each wave as one {wave_kernel} launch")
        emit({"phase": "msm_check", "group": name, "n": int(zkey.n_vars),
              "seconds": round(dt, 3), "waves": eng.last_waves, wave_kernel: c[wave_kernel]})

    emit({"phase": "prove_full", "log_n": log_n, "constraints": zkey.matrices.num_constraints,
          "zkey_build_s": round(build_s, 2), "prove_cold_s": round(cold, 3),
          "prove_warm_s": round(warm, 3), "spans_cold_party0": spans_cold,
          "spans_warm_party0": spans_warm, "peak_device_bytes": int(peak),
          "proofs_identical": True, "on_curve": True})
    return counts_cold


def msm_cases(curve, d, zkey, k_a, k_b2, fr, s_std) -> dict:
    """{group: (driver d's engine, curve ops, query points, the host's
    (sum k_i s_i) G)} for one G1 and one G2 query of the synthetic zkey,
    whose points are known multiples k_i of the generator."""
    s_int = fr.from_limbs(s_std).tolist()

    def known(ks, host):
        return host(curve, sum(int(k) * int(v) for k, v in zip(ks.tolist(), s_int)))

    return {"g1": (d.msm_g1_engine, d.g1, d.g1_proj(zkey.a_query), known(k_a, host_mul_g1)),
            "g2": (d.msm_g2_engine, d.g2, d.g2_proj(zkey.b_g2_query), known(k_b2, host_mul_g2))}


# ------------------------------------------------------ phase: prove_sharded

def phase_prove_sharded(curve, device, log_n: int, inputs) -> dict:
    """The device-sharded path at full width: the 3-party REP3 proof of
    prove_full's zkey with every party's driver built with `devices`.
    Returns the launch counts of that proof alone."""
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.curve import pmap
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.parallel.sharded import (ShardedMSMEngine, ShardedNTTEngine,
                                                     device_list)

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    gen = torch.Generator().manual_seed(4444)
    zkey, k_a, k_b2, shares, _ = inputs
    devices = device_list(max(2, torch.cuda.device_count()))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    proofs, cold, spans = prove_rep3(curve, zkey, shares, device, traced=True, devices=devices)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(proofs[0] == proofs[1] == proofs[2], "prove_sharded: the parties' proofs differ")
    check(on_curve(curve, proofs[0]), "prove_sharded: a proof point is not on its curve")
    check(counts["ec_wave_add"] > 0, "prove_sharded: ec_wave_add was never launched")
    check(counts["ec_wave_add_g2"] > 0, "prove_sharded: ec_wave_add_g2 was never launched")

    local = PlainDriver(curve, device=device)
    dist = PlainDriver(curve, devices=devices)
    check(isinstance(dist.msm_g1_engine, ShardedMSMEngine)
          and isinstance(dist.msm_g2_engine, ShardedMSMEngine)
          and isinstance(dist.ntt, ShardedNTTEngine), "prove_sharded: the engines are not sharded")

    # a sharded 2^log_n NTT and iNTT against the local engine, bit for bit
    x = rand_field(fr, (zkey.domain_size,), gen)
    ntt_s = {}
    for name in ("ntt", "intt"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = getattr(dist.ntt, name)(x)
        torch.cuda.synchronize()
        ntt_s[name] = round(time.perf_counter() - t1, 4)
        check(torch.equal(got, getattr(local.ntt, name)(x)),
              f"prove_sharded: the sharded {name} differs from the local engine's")

    # the same scalars through the sharded and the local engine on one G1 and
    # one G2 query: equal affine points, equal to the known discrete log
    s_std = rand_field(fr, (zkey.n_vars,), gen)
    local_cases = msm_cases(curve, local, zkey, k_a, k_b2, fr, s_std)
    for name, (eng, ops, arr, want) in msm_cases(curve, dist, zkey, k_a, k_b2, fr, s_std).items():
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        res = eng.msm(arr, s_std)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        c = kernels.launch_counts()
        got = ops.decode_points(pmap(lambda t: t[:, None], res))[0]
        loc = local_cases[name][0].msm(arr, s_std)
        check(got == ops.decode_points(pmap(lambda t: t[:, None], loc))[0],
              f"prove_sharded: sharded MSM {name} differs from the local engine's")
        check(got == want, f"prove_sharded: sharded MSM {name} != (sum k_i s_i) G")
        if name == "g1":
            check(c["ec_madd"] == 0 and c["ec_wave_add"] == eng.last_waves > 0,
                  "prove_sharded: the sharded G1 MSM did not run its waves through ec_wave_add")
        else:
            check(c["ec_wave_add_g2"] == eng.last_waves > 0,
                  "prove_sharded: the sharded G2 MSM did not run its waves through ec_wave_add_g2")
        emit({"phase": "sharded_msm_check", "group": name, "n": int(zkey.n_vars),
              "seconds": round(dt, 3), "waves": eng.last_waves,
              "ec_wave_add": c["ec_wave_add"], "ec_wave_add_g2": c["ec_wave_add_g2"],
              "ec_madd": c["ec_madd"]})

    emit({"phase": "prove_sharded", "log_n": log_n, "devices": [str(d) for d in devices],
          "constraints": zkey.matrices.num_constraints, "prove_cold_s": round(cold, 3),
          "spans_party0": spans, "launches": {k: v for k, v in counts.items() if v},
          "peak_device_bytes": int(peak),
          "sharded_ntt_s": ntt_s, "proofs_identical": True, "on_curve": True})
    return counts


# ---------------------------------------------------------- phase: prove_bls

def phase_prove_bls(device, n_mul: int) -> dict:
    """The hand-built circuit over BLS12-381 (Fq: the 12-limb kernels; Fr: the
    8-limb NTT kernels with its constants): one 3-party REP3 proof through
    one-device drivers (mixed-add G1 waves) and one through sharded drivers
    (`ec_wave_add`), both verified.  Returns the two proofs' launch counts."""
    from cocircom_tpu_torch.fields.params import BLS12_381 as curve
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.curve import pmap
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.parallel.sharded import device_list

    zkey, vk, shares, publics, setup_s = small_inputs(curve, device, n_mul, b"chip_smoke_bls")
    devices = device_list(max(2, torch.cuda.device_count()))
    kernels.reset_launch_counts()
    proofs, wall, _ = prove_rep3(curve, zkey, shares, device, traced=False)
    proofs_s, wall_s, _ = prove_rep3(curve, zkey, shares, device, traced=False, devices=devices)
    counts = kernels.launch_counts()
    check_small_proofs("prove_bls", vk, proofs, publics)
    check_small_proofs("prove_bls (sharded)", vk, proofs_s, publics)
    for k in ("mont_mul", "ec_add", "ec_madd", "ec_wave_add", "ec_add_g2", "ec_wave_add_g2"):
        check(counts[kernels.count_key(k, 12)] > 0,
              f"prove_bls: the 12-limb {k} was never launched")
    # one G1 MSM of the zkey's a_query through each driver's engine: equal
    # results, and each wave one launch of its 12-limb wave kernel
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    s_std = rand_field(fr, (zkey.n_vars,), torch.Generator().manual_seed(4545))
    res, waves = [], {}
    for drv, key in ((PlainDriver(curve, device=device), "ec_madd_l12"),
                     (PlainDriver(curve, devices=devices), "ec_wave_add_l12")):
        kernels.reset_launch_counts()
        pt = drv.msm_g1_engine.msm(drv.g1_proj(zkey.a_query), s_std)
        c = kernels.launch_counts()
        eng_waves = drv.msm_g1_engine.last_waves
        check(c[key] == eng_waves > 0 and sum(c[k] for k in ("ec_madd_l12", "ec_wave_add_l12"))
              == eng_waves, f"prove_bls: the G1 MSM did not run each wave as one {key} launch")
        res.append(drv.g1.decode_points(pmap(lambda t: t[:, None], pt))[0])
        waves[key] = eng_waves
    check(res[0] == res[1], "prove_bls: the sharded G1 MSM differs from the local engine's")
    emit({"phase": "prove_bls", "curve": curve.name, "constraints": n_mul,
          "domain": zkey.domain_size, "setup_s": round(setup_s, 2),
          "prove_s": round(wall, 3), "prove_sharded_s": round(wall_s, 3),
          "verified": True, "tamper_rejected": True, "g1_msm_waves": waves,
          "launches": {k: v for k, v in counts.items() if v}})
    return counts


# -------------------------------------------------------------- phase: graft

def phase_graft(curve, device) -> None:
    """graft_entry's two entry points on the card."""
    from cocircom_tpu_torch import graft_entry
    from cocircom_tpu_torch.ops.curve import ProjPoint, g1_ops, pmap
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.ops.msm import msm_engine

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    x, y, z = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    check(all(t.is_cuda and tuple(t.shape) == (8,) for t in (x, y, z)),
          "graft: entry() did not return one G1 point on the card")
    # the same step through the local engine's mixed-add MSM
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    ops = g1_ops(curve, device)
    a, b, c, px, py, pz = args
    want = msm_engine(ops).msm(ProjPoint(px, py, pz), fr.from_mont(fr.sub(fr.mont_mul(a, b), c)))
    dec = lambda pt: ops.decode_points(pmap(lambda t: t[:, None], pt))[0]  # noqa: E731
    check(dec(ProjPoint(x, y, z)) == dec(want), "graft: entry() disagrees with the MSM engine")
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(2)
    torch.cuda.synchronize()
    emit({"phase": "graft", "entry_s": round(entry_s, 3),
          "dryrun_multichip_2_s": round(time.perf_counter() - t0, 3)})


# ------------------------------------------------- phase: profile (optional)

def phase_profile(curve, device, log_n: int, inputs) -> None:
    """One warm 3-party proof of prove_full's size under torch.profiler
    (device activity only) with one-device drivers, and one with sharded
    drivers (prove_sharded's path): for each the share of the wall time in
    which the card ran a kernel, and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from cocircom_tpu_torch.parallel.sharded import device_list

    zkey, _, _, shares, _ = inputs
    for path, devices in (("prove_full", None),
                          ("prove_sharded", device_list(max(2, torch.cuda.device_count())))):
        prove_rep3(curve, zkey, shares, device, traced=False, devices=devices)   # not profiled
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall, _ = prove_rep3(curve, zkey, shares, device, traced=False, devices=devices)
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append((e.key, int(e.count), us / 1e3))
        check(rows, "profile: the profiler recorded no device time")
        rows.sort(key=lambda r: -r[2])
        busy_ms = sum(r[2] for r in rows)
        emit({"phase": "profile", "path": path, "log_n": log_n,
              "prove_warm_profiled_s": round(wall, 3), "device_busy_ms": round(busy_ms, 1),
              "device_busy_share": round(busy_ms / (wall * 1e3), 4),
              "device_kernel_launches": sum(r[1] for r in rows),
              "top_kernels": [{"name": k[:80], "count": c, "ms": round(ms, 1)}
                              for k, c, ms in rows[:16]]})


# --------------------------------------------------------------------- main

def ptxas_report(build_dir) -> dict:
    """Registers, stack and spill bytes of every __global__ instantiation,
    from the `-Xptxas -v` logs the build keeps beside the libraries."""
    from cocircom_tpu_torch.ops import kernels

    out = {}
    for log in sorted(build_dir.glob("lib*.log")):
        out.update(kernels.parse_ptxas(log.read_text()))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--full-log", type=int, default=20)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES + OPTIONAL_PHASES:
            fail(f"unknown phase {p!r}")

    from cocircom_tpu_torch.fields.params import BLS12_381
    from cocircom_tpu_torch.fields.params import BN254 as curve

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    device = "cuda"
    full_sized = [p for p in ("prove_full", "prove_sharded", "profile") if p in phases]
    if full_sized and args.full_log < 18:
        fail("prove_full and prove_sharded run at 2^18 constraints or more")

    from cocircom_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi gave no device line")
    smi_line = smi.stdout.strip().splitlines()[0]

    if "build" in phases:
        t0 = time.perf_counter()
        kernels.build_all()
        kernels.load_all()
        emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
              "seconds_by_source": dict(kernels.build_seconds),
              "kernels": list(kernels.KERNELS), "limbs": list(kernels.LIMBS),
              "dir": str(kernels.build_dir().name), "ptxas": ptxas_report(kernels.build_dir())})
    if "device" in phases:
        emit({"phase": "device", "nvidia_smi": smi_line,
              "torch": torch.__version__, "cuda": torch.version.cuda})

    rows = []
    if "kernels" in phases:
        rows = phase_kernels(curve, device) + phase_kernels(BLS12_381, device)

    zero = {k: 0 for k in kernels.COUNT_KEYS}
    runs = {"prove_small": zero, "prove_full_cold": zero, "prove_sharded": zero, "prove_bls": zero}
    if "prove_small" in phases:
        runs["prove_small"] = phase_prove_small(curve, device, SMALL_MULS)
    inputs = None
    if full_sized:
        inputs = full_inputs(curve, device, args.full_log, torch.Generator().manual_seed(4242))
    if "prove_full" in phases:
        runs["prove_full_cold"] = phase_prove_full(curve, device, args.full_log, inputs)
    if "prove_sharded" in phases:
        runs["prove_sharded"] = phase_prove_sharded(curve, device, args.full_log, inputs)
    if "profile" in phases:
        phase_profile(curve, device, args.full_log, inputs)
    del inputs
    if "prove_bls" in phases:
        runs["prove_bls"] = phase_prove_bls(device, BLS_MULS)
    if "graft" in phases:
        phase_graft(curve, device)
    counts = {k: sum(r[k] for r in runs.values()) for k in kernels.COUNT_KEYS}
    emit({"phase": "launches", **{name: {k: v for k, v in r.items() if v}
                                  for name, r in runs.items()}})

    if set(phases) != set(ALL_PHASES):
        emit({"phase": "partial", "phases": phases,
              "launches": {k: v for k, v in counts.items() if v},
              "seconds": round(time.perf_counter() - t_start, 1)})
        print(smi_line, flush=True)
        return

    for r in rows:
        r["launches"] = counts[r["name"]]
    # the 12-limb builds of the two NTT kernels are held to their plain
    # versions above, but no path runs them (both curves' Fr has 8 limbs):
    # they are reported apart and the line below lists the paths' kernels
    off_path = [r for r in rows if r["name"] in ("ntt_butterfly_l12", "ntt_columns_l12")]
    rows = [r for r in rows if r not in off_path]
    emit({"phase": "kernels_off_path", "kernels": off_path})
    for r in rows:
        check(r["launches"] > 0, f"kernel {r['name']} was never launched on a proving path")
    check(not any(t.name.startswith("party-") for t in threading.enumerate()),
          "a party's thread is still alive")
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1)})
    print(smi_line, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
