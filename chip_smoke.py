#!/usr/bin/env python3
"""End-to-end proof that the PyTorch/CUDA port starts and proves on one GPU.

Run from the repository root with no arguments, on a machine with one
NVIDIA card, nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  build        compile the CUDA kernels from cocircom_tpu_torch/csrc
  device       the card's name and power limit as nvidia-smi gives them
  kernels      each kernel against its plain PyTorch version on the card at
               the shapes the prover gives it, bit for bit (tolerance 0),
               plus edge inputs; times for kernel and plain version; the
               least time the card could take (bound)
  prove_small  hand-built R1CS -> groth16_setup -> zkey bytes -> loader ->
               3-party REP3 proof on the card -> pairing verifier accepts,
               the three proofs are equal, a changed public input is refused
  prove_full   synthetic zkey at 2^20 constraints built on the card, 3-party
               REP3 proof cold and warm; proofs equal and on curve; NTT
               round trips; one G1 and one G2 MSM against a host-computed
               known discrete log
The launch counts are set to 0 just before each phase's first 3-party proof
and read just after it, so they hold the proving path alone; a line
{"phase": "launches", ...} gives the two proofs' counts apart.  Then one
line {"kernels": [...]} whose launches are their sum, the nvidia-smi line,
and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Options (for shorter measurement runs):
  --phases a,b,..   run only these phases (the final ok line is printed only
                    after a full run).  One more phase runs only when named
                    here: `profile`, a warm prove_full-sized proof under
                    torch.profiler, which prints the card's busy share of the
                    wall time and the device time by kernel
  --full-log N      size of prove_full (default 20; never below 18)

Integer peak used for the bound: the card's table gives 67 TFLOP/s float32
outside the tensor cores, i.e. 33.5e12 fused multiply-adds a second on 128
lanes per SM; 32-bit integer multiply-adds issue on half as many lanes, so
16.75e12 a second.  Memory rate: 3.35e12 bytes a second.
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
MADS_PER_MUL = 2 * 8 * 8 + 8  # 32-bit multiply-adds of one BN254 Montgomery product

SMALL_MULS = 300  # constraints of prove_small's multiplier chain

ALL_PHASES = ("build", "device", "kernels", "prove_small", "prove_full")
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


def prove_rep3(curve, zkey, shares, device, traced: bool):
    """Three party threads over the in-process network; returns
    (proofs, wall seconds, per-span seconds of party 0)."""
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.snark.groth16 import CoGroth16
    from cocircom_tpu_torch.utils.trace import Tracer

    rows = []

    def party(i, net):
        tracer = Tracer(enabled=traced and i == 0, net=net, sync=torch.cuda.synchronize)
        proof = CoGroth16(Rep3Driver(curve, net, device=device), tracer).prove(
            zkey, shares[i])
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
    """Every kernel against its plain version at the main path's shapes."""
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.curve import (ProjPoint, ec_add_g2_plain, ec_add_plain,
                                              ec_madd, ec_madd_plain, g1_ops, g2_ops,
                                              leaves, pmap)
    from cocircom_tpu_torch.ops.field import get_field, mont_mul_plain
    from cocircom_tpu_torch.ops.ntt import (butterfly, butterfly_plain, ntt_columns,
                                            ntt_columns_plain, ntt_engine)

    gen = torch.Generator().manual_seed(20)
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    fq = get_field(curve.fq.p, curve.name + ".fq", device)
    g1 = g1_ops(curve, device)
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

    def record(name, source, replaces, err, ms, plain_ms, nbytes, mads, shape):
        b_ms, by = bound(nbytes, mads)
        out.append({
            "name": name, "route": "cuda",
            "source": f"cocircom_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "shape": shape,
        })

    def max_err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    # ---- K1 mont_mul: (8, 2^20) x (8, 2^20), Fr (coset shift, mul_vec) ----
    n = 1 << 20
    a = rand_field(fr, (n,), gen)
    b = rand_field(fr, (n,), gen)
    a[:, :64] = edge(fr, 64)
    b[:, :64] = edge(fr, 64).roll(1, dims=1)
    got = fr.mont_mul(a, b)
    err = max_err(got, mont_mul_plain(fr, a, b))
    single = b[:, :1].contiguous()
    err = max(err, max_err(fr.mont_mul(a, single), mont_mul_plain(fr, a, single)))
    qa, qb = edge(fq, 4096), rand_field(fq, (4096,), gen)
    err = max(err, max_err(fq.mont_mul(qa, qb), mont_mul_plain(fq, qa, qb)))
    check(err == 0, f"mont_mul disagrees with mont_mul_plain (max abs err {err})")
    ms = time_cuda(lambda: fr.mont_mul(a, b), 50)
    pms = timed_plain(lambda: mont_mul_plain(fr, a, b))
    record("mont_mul", "mont_mul.cu", "cocircom_tpu/ops/pallas_field.py:593", err, ms, pms,
           96 * n, MADS_PER_MUL * n, [8, n])

    # ---- K2 ntt_butterfly: (8, 1024): a stage of the 2^11-point transform,
    # the largest the per-stage engine runs ----
    n = 1 << 10
    e, o, w = (rand_field(fr, (n,), gen) for _ in range(3))
    e[:, :64] = edge(fr, 64)
    o[:, :64] = edge(fr, 64).roll(2, dims=1)
    w[:, :64] = edge(fr, 64).roll(1, dims=1)
    ge, go = butterfly(fr, e, o, w)
    pe, po = butterfly_plain(fr, e, o, w)
    err = max(max_err(ge, pe), max_err(go, po))
    big = [rand_field(fr, (1 << 16,), gen) for _ in range(3)]
    g2_, p2_ = butterfly(fr, *big), butterfly_plain(fr, *big)
    err = max(err, max_err(g2_[0], p2_[0]), max_err(g2_[1], p2_[1]))
    check(err == 0, f"ntt_butterfly disagrees with butterfly_plain (max abs err {err})")
    ms = time_cuda(lambda: butterfly(fr, e, o, w), 200)
    pms = timed_plain(lambda: butterfly_plain(fr, e, o, w))
    record("ntt_butterfly", "ntt_butterfly.cu", "cocircom_tpu/ops/pallas_field.py:502", err,
           ms, pms, 160 * n, MADS_PER_MUL * n, [8, n])

    # ---- K3 ntt_columns: (8, 1024, 1024): the first level of a 2^20 NTT ----
    M, B = 1 << 10, 1 << 10
    eng = ntt_engine(fr, curve.fr)
    tw = eng._twiddles(10, False)
    x = rand_field(fr, (M, B), gen)
    x[:, :8, :8] = edge(fr, 64).reshape(8, 8, 8)
    got = ntt_columns(fr, x, tw)
    err = max_err(got, ntt_columns_plain(fr, x, tw))
    for logm, cols in ((1, 5), (4, 3), (9, 64), (10, 64)):
        xs = rand_field(fr, (1 << logm, cols), gen)
        tws = eng._twiddles(logm, True)
        err = max(err, max_err(ntt_columns(fr, xs, tws), ntt_columns_plain(fr, xs, tws)))
    check(err == 0, f"ntt_columns disagrees with ntt_columns_plain (max abs err {err})")
    ms = time_cuda(lambda: ntt_columns(fr, x, tw), 10)
    pms = timed_plain(lambda: ntt_columns_plain(fr, x, tw))
    record("ntt_columns", "ntt_columns.cu", "cocircom_tpu/ops/pallas_ntt.py:223", err, ms, pms,
           2 * 32 * M * B + 32 * (M // 2), 10 * (M // 2) * B * MADS_PER_MUL, [8, M, B])
    del x, got

    # ---- K4 ec_add: (8, 22, 2048): the bucket-reduction suffix sums of a
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
    check(err == 0, f"ec_add disagrees with ec_add_plain (max abs err {err})")
    dec = g1.decode_points(ProjPoint(*(c[:, 40:56] for c in got)))
    check(all(d is None for d in dec[8:]), "ec_add: P + (-P) is not the identity")
    ms = time_cuda(lambda: g1.add(P, Q), 50)
    pms = timed_plain(lambda: ec_add_plain(fq, g1._b3_mont, P, Q))
    record("ec_add", "ec_add.cu", "cocircom_tpu/ops/pallas_curve.py:225", err, ms, pms,
           288 * nl, 14 * MADS_PER_MUL * nl, [8, 22, 2048])

    # ---- K5 ec_madd: (8, 22, 2049, 8) lanes: one wave of a c = 12 MSM ----
    nl = 22 * 2049 * 8
    small = torch.randint(1, 1 << 15, (1, nl), generator=gen, dtype=torch.int64)
    pts = g1.scalar_mul(base, small.to(torch.int32).to(device), nbits=15)
    ax, ay = g1.to_affine_limbs(pts)
    rows = torch.cat([ax, ay], dim=0).t().contiguous()
    rows[5:9] = 0                                           # (0,0) rows: identity
    valid = torch.rand(nl, generator=gen).to(device) < 0.8  # invalid lanes pass
    acc0 = ProjPoint(*(c.reshape(8, 22, 2049, 8).contiguous() for c in (
        ax.roll(7, dims=1), ay.roll(7, dims=1), fq.one_mont((nl,)).contiguous())))
    ref = ec_madd_plain(fq, acc0, rows, valid)
    acc = ProjPoint(*(c.clone() for c in acc0))
    got = ec_madd(fq, acc, rows, valid)
    err = max(max_err(g, r) for g, r in zip(got, ref))
    check(err == 0, f"ec_madd disagrees with ec_madd_plain (max abs err {err})")
    untouched = ~valid
    untouched[5:9] = True
    check(all(torch.equal(g.reshape(8, -1)[:, untouched], a.reshape(8, -1)[:, untouched])
              for g, a in zip(got, acc0)), "ec_madd: a masked lane changed")
    n_valid = int(valid.sum().item())
    n_live = n_valid - int(valid[5:9].sum().item())
    ms = time_cuda(lambda: ec_madd(fq, acc, rows, valid), 50)
    pms = timed_plain(lambda: ec_madd_plain(fq, acc0, rows, valid))
    record("ec_madd", "ec_madd.cu", "cocircom_tpu/ops/pallas_curve.py:507", err, ms, pms,
           nl + 64 * n_valid + 192 * n_live, 11 * MADS_PER_MUL * n_live, [8, 22, 2049, 8])

    # ---- ec_add_g2: (8, 22, 2049, 8) lanes over Fq2: one wave of a c = 12
    # G2 MSM.  The plain version stacks 18 base products per lane in int64
    # columns, so it runs over slices of the lane axis (2 windows each) ----
    g2 = g2_ops(curve, device)
    nl = 22 * 2049 * 8
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
    check(err == 0, f"ec_add_g2 disagrees with ec_add_g2_plain (max abs err {err})")
    dec = g2.decode_points(ProjPoint(*((c[0][:, 48:56], c[1][:, 48:56]) for c in got)))
    check(all(d is None for d in dec), "ec_add_g2: P + (-P) is not the identity")
    ms = time_cuda(lambda: g2.add(P2, Q2), 20)
    pms = timed_plain(lambda: g2_plain(P2, Q2))
    record("ec_add_g2", "ec_add.cu", "cocircom_tpu/ops/curve.py:223", err, ms, pms,
           576 * nl, 42 * MADS_PER_MUL * nl, [8, 22, 2049, 8])
    del P2, Q2, got, ref

    emit({"phase": "kernels", "kernels": [k["name"] for k in out], "tolerance": 0,
          "detail": [{k: v for k, v in r.items() if k in
                      ("name", "ms", "plain_ms", "bound_ms", "bound_by", "shape")}
                     for r in out],
          "launches_during_checks": kernels.launch_counts()})
    return out


# -------------------------------------------------------- phase: prove_small

def multiplier_chain(curve, n_mul: int, a_val: int):
    """R1CS of y = a^(n_mul+1) as a chain of multiplications.  Wires: 0 = 1,
    1 = y (public output), 2 = a (public input), 3.. = intermediates."""
    from cocircom_tpu_torch.io.r1cs import R1CS

    p = curve.fr.p
    vals = [1, None, a_val % p]
    cons = []
    cur = 2
    for i in range(n_mul):
        out = 1 if i == n_mul - 1 else len(vals)
        cons.append(([(cur, 1)], [(2, 1)], [(out, 1)]))
        v = vals[cur] * vals[2] % p
        if out == 1:
            vals[1] = v
        else:
            vals.append(v)
        cur = out
    r1cs = R1CS(curve=curve, n_wires=len(vals), n_pub_out=1, n_pub_in=1, n_prv_in=0,
                n_labels=len(vals), n_constraints=len(cons), constraints=cons,
                wire_mapping=[])
    return r1cs, vals


def phase_prove_small(curve, device, n_mul: int) -> dict:
    """Returns the launch counts of the 3-party proof alone."""
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.io.witness import Witness
    from cocircom_tpu_torch.io.zkey import read_groth16_zkey
    from cocircom_tpu_torch.ops.field import ints_to_limbs_np
    from cocircom_tpu_torch.snark.groth16_verify import verify_groth16
    from cocircom_tpu_torch.snark.setup import groth16_setup
    from cocircom_tpu_torch.snark.shared import split_witness_rep3

    t0 = time.perf_counter()
    r1cs, vals = multiplier_chain(curve, n_mul, 3)
    zkey_bytes, vk = groth16_setup(r1cs, seed=b"chip_smoke")
    setup_s = time.perf_counter() - t0
    zkey = read_groth16_zkey(zkey_bytes, device=device)
    wit = Witness(curve, len(vals), ints_to_limbs_np(vals, 8))
    shares = split_witness_rep3(wit, 2, seed=7, device=device)
    kernels.reset_launch_counts()
    proofs, wall, _ = prove_rep3(curve, zkey, shares, device, traced=False)
    counts = kernels.launch_counts()
    publics = [vals[1], vals[2]]
    check(proofs[0] == proofs[1] == proofs[2], "prove_small: the parties' proofs differ")
    check(verify_groth16(vk, proofs[0], publics), "prove_small: the verifier refused the proof")
    check(not verify_groth16(vk, proofs[0], [publics[0], publics[1] + 1]),
          "prove_small: the verifier accepted a changed public input")
    emit({"phase": "prove_small", "constraints": r1cs.n_constraints,
          "domain": zkey.domain_size, "setup_s": round(setup_s, 2),
          "prove_s": round(wall, 3), "verified": True, "tamper_rejected": True})
    return counts


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


def phase_prove_full(curve, device, log_n: int) -> dict:
    """Returns the launch counts of the cold 3-party proof alone."""
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.curve import pmap
    from cocircom_tpu_torch.ops.field import get_field

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    gen = torch.Generator().manual_seed(4242)
    zkey, k_a, k_b2, shares, build_s = full_inputs(curve, device, log_n, gen)

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

    # NTT round trip at the size the witness map uses
    d = PlainDriver(curve, device=device)
    x = rand_field(fr, (zkey.domain_size,), gen)
    check(torch.equal(d.ntt.intt(d.ntt.ntt(x)), x), "prove_full: intt(ntt(x)) != x")

    # one G1 and one G2 MSM against the known discrete log
    s_std = rand_field(fr, (zkey.n_vars,), gen)
    s_int = fr.from_limbs(s_std)
    for name, eng, ops, arr, ks, host in (
            ("g1", d.msm_g1_engine, d.g1, d.g1_proj(zkey.a_query), k_a, host_mul_g1),
            ("g2", d.msm_g2_engine, d.g2, d.g2_proj(zkey.b_g2_query), k_b2, host_mul_g2)):
        t1 = time.perf_counter()
        res = eng.msm(arr, s_std)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = ops.decode_points(pmap(lambda c: c[:, None], res))[0]
        total = int(sum(int(k) * int(s) for k, s in zip(ks.tolist(), s_int.tolist()))
                    % curve.fr.p)
        check(got == host(curve, total), f"prove_full: MSM {name} != (sum k_i s_i) G")
        emit({"phase": "msm_check", "group": name, "n": int(zkey.n_vars),
              "seconds": round(dt, 3), "waves": eng.last_waves})

    emit({"phase": "prove_full", "log_n": log_n, "constraints": zkey.matrices.num_constraints,
          "zkey_build_s": round(build_s, 2), "prove_cold_s": round(cold, 3),
          "prove_warm_s": round(warm, 3), "spans_cold_party0": spans_cold,
          "spans_warm_party0": spans_warm, "peak_device_bytes": int(peak),
          "proofs_identical": True, "on_curve": True})
    return counts_cold


# ------------------------------------------------- phase: profile (optional)

def phase_profile(curve, device, log_n: int) -> None:
    """One warm 3-party proof of prove_full's size under torch.profiler
    (device activity only): the share of the wall time in which the card ran
    a kernel, and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    zkey, _, _, shares, _ = full_inputs(curve, device, log_n,
                                        torch.Generator().manual_seed(4242))
    prove_rep3(curve, zkey, shares, device, traced=False)      # cold, not profiled
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall, _ = prove_rep3(curve, zkey, shares, device, traced=False)
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
    emit({"phase": "profile", "log_n": log_n, "prove_warm_profiled_s": round(wall, 3),
          "device_busy_ms": round(busy_ms, 1),
          "device_busy_share": round(busy_ms / (wall * 1e3), 4),
          "device_kernel_launches": sum(r[1] for r in rows),
          "top_kernels": [{"name": k[:80], "count": c, "ms": round(ms, 1)}
                          for k, c, ms in rows[:16]]})


# --------------------------------------------------------------------- main

def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--full-log", type=int, default=20)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES + OPTIONAL_PHASES:
            fail(f"unknown phase {p!r}")

    from cocircom_tpu_torch.fields.params import BN254 as curve

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    device = "cuda"
    if ("prove_full" in phases or "profile" in phases) and args.full_log < 18:
        fail("prove_full runs at 2^18 constraints or more")

    from cocircom_tpu_torch.ops import kernels

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
              "kernels": list(kernels.KERNELS), "dir": str(kernels.build_dir().name)})
    if "device" in phases:
        emit({"phase": "device", "nvidia_smi": smi_line,
              "torch": torch.__version__, "cuda": torch.version.cuda})

    rows = phase_kernels(curve, device) if "kernels" in phases else []

    zero = {k: 0 for k in kernels.KERNELS}
    small = phase_prove_small(curve, device, SMALL_MULS) if "prove_small" in phases else zero
    full = phase_prove_full(curve, device, args.full_log) if "prove_full" in phases else zero
    counts = {k: small[k] + full[k] for k in kernels.KERNELS}
    emit({"phase": "launches", "prove_small": small, "prove_full_cold": full})

    if "profile" in phases:
        phase_profile(curve, device, args.full_log)

    if set(phases) != set(ALL_PHASES):
        emit({"phase": "partial", "phases": phases, "launches": counts})
        print(smi_line, flush=True)
        return

    for r in rows:
        r["launches"] = counts[r["name"]]
        check(r["launches"] > 0, f"kernel {r['name']} was never launched on the proving path")
    check(not any(t.name.startswith("party-") for t in threading.enumerate()),
          "a party's thread is still alive")
    print(smi_line, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
