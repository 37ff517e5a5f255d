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
                 the first and the last wave, with edge lanes; K2
                 ntt_butterfly as whole 2^1-2^11-point transforms (2^9 and
                 2^11 timed), forward and inverse; K3 ntt_columns as the
                 column pass and the fused pass (four-step factor, transposed
                 store) at (L, 1024, 1024) with ragged column counts, and
                 whole 2^20 transforms through the engine (two launches each,
                 held to the plain decomposition and to the per-stage
                 network), and the three level shapes of a 2^22 transform
                 (1024 points with V = 4096 and a factor table, 1024 with
                 V = 4 and B = 1024, 4 over 2^20 columns).  Once over
                 BN254 (8 limbs) and once over BLS12-381 (the 12-limb builds
                 over Fq, and the 8-limb NTT kernels with BLS12-381 Fr's
                 constants)
  prove_small    hand-built R1CS -> groth16_setup -> zkey bytes -> loader ->
                 3-party REP3 proof on the card -> pairing verifier accepts,
                 the three proofs are equal, a changed public input is
                 refused; each of the witness map's 36 small transforms one
                 ntt_butterfly launch
  prove_full     synthetic zkey at 2^20 constraints built on the card, 3-party
                 REP3 proof cold and warm; proofs equal and on curve; the G2
                 waves went through `ec_wave_add_g2`; each of the witness
                 map's 36 transforms two ntt_columns launches, and no
                 mont_mul in a transform; NTT round trips; one G1
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
  prove_shamir   3-party Shamir co-Groth16 (t = 1): prove_small's chain through
                 the setup (verified, the three proofs equal, a changed
                 public input refused), then prove_full's synthetic zkey with
                 its REP3 shares translated to Shamir (translate_rep3_to_shamir):
                 the translated witness w and a 2^20 product w * roll(w)
                 opened and held to the REP3-opened witness; proofs equal and
                 on curve, the G2 waves through `ec_wave_add_g2`; wall and
                 party 0's three spans
  prove_bls      the hand-built circuit over BLS12-381 through groth16_setup
                 and the loader: a 3-party REP3 proof with one-device
                 drivers and one with sharded drivers; the pairing verifier
                 accepts both and refuses a changed public input; one G1 MSM
                 through each driver's engine, equal, each wave one launch of
                 its 12-limb wave kernel
  plonk_small    the port's plonk_setup on a chain with one two-term side (one
                 addition) over BN254 (200 gates, domain 256): a Plain, a REP3
                 and a Shamir co-PLONK proof, each accepted by verify_plonk
                 and refused with a changed public input, each transform one
                 `ntt_butterfly` launch; with deterministic blinding
                 (COCIRCOM_INSECURE_DETERMINISTIC=1 for those calls only) the
                 three proofs' JSON byte-equal; the same over BLS12-381 at
                 100 gates, Plain and REP3
  plonk_full     a PLONK key of a 2^PLONK_LOG-gate multiplier chain built on the card
                 with a real tau from a seed (p_tau by a batched scalar
                 multiplication, selectors and sigma from the gate layout and
                 the copy cycles, iNTT, NTT on the 4x extended domain,
                 commitments by the MSM); a 3-party REP3 proof cold and warm
                 and a Shamir one, each accepted by verify_plonk; each
                 extended-domain transform `ntt_columns` launches and
                 nothing else, one each way held to the plain version of
                 its levels, and one `mont_mul` at round 3's widest product
                 (8, 32 x 4 n) to the plain version; PLONK_LOG = 18 (cut
                 from 2^20 so the whole script fits its time limit);
                 mont_mul, ntt_columns, ec_add and ec_madd launched; walls,
                 party 0's five round spans, peak device memory, the key's
                 build seconds, launches per kernel
  vm_small       the circom witness extension on the card: the inline sources
                 of tests/test_torch_vm.py (signed comparisons with p-1 as
                 -1, Num2Bits-style shifts and band/bor/bxor chains, shl/shr,
                 pow, sqrt, guarded division by a secret zero, cmux) compiled
                 by the port's compile_circom and run under REP3, the
                 arithmetic ones also under Shamir (t = 1), the comparisons
                 also over BLS12-381 (9-limb binary shares): every party's
                 opened witness equal to run_host at every slot, REP3 shares
                 replicated; then the pipeline: Chain(300) (the multiplier
                 chain of prove_small, wire for wire) split by
                 split_input_rep3 with `a` public, run_shared_input under REP3
                 (publics [1, 3^301, 3]), a REP3 co-Groth16 proof of the
                 shared witness with the zkey of groth16_setup(multiplier_chain),
                 the three proofs equal, verified, a changed public input
                 refused; mont_mul launched by the VM
  vm_full        the witness extension at a larger size: VM_FULL_N cells (256,
                 cut from 1,024 so the whole script fits its time limit), each a Num2Bits(254), a signed a < b, an
                 a == b, (a & b) ^ (a | b) (binary-resident, b2a exit),
                 a * b, a ** 5 and a guarded a / b (about 774 ops and 261
                 witness slots a cell), inputs from a seed; host compile and run_host timed apart; REP3 on the
                 card cold and warm, the whole witness opened and equal to
                 run_host at every slot; walls, party 0's rounds and bytes,
                 launches, peak device memory
  cli            the port's command line (python -m cocircom_tpu_torch.cli) as
                 separate party processes on the card, once the earlier phases
                 have let go of it (torch.cuda.empty_cache; free memory
                 printed): gen-cert three times, then every mesh under mutual
                 TLS (plain TCP, and gen-cert must fail naming the package,
                 where `cryptography` does not import); small pipelines on
                 SplitChain, prove_small's 300-constraint chain with its first
                 factor split into two private inputs (write_r1cs writes its
                 .r1cs): setup groth16 and plonk, split-input by two input
                 providers, merge-input-shares, three generate-witness
                 --protocol rep3 (the opened witness equal to run_host),
                 REP3, Shamir (translate-witness) and PLONK proofs, a plain
                 witness, split and proof; verify accepts each proof and
                 refuses a changed public input, the parties' proof files
                 byte-equal.  Then prove_full's synthetic key written as a
                 .zkey file (write_groth16_zkey, read back equal) and its REP3
                 shares as .shared files, and three generate-proof groth16
                 processes at 2^20 with COCIRCOM_TRACE=1: proofs byte-equal
                 and on curve; each party's startup, zkey read, prove and
                 span seconds, bytes, peak device memory and launches (K1,
                 K3, K4, K5, the G2 add and the G2 wave must show), the wall
                 from spawn to the last exit beside this run's warm
                 in-process prove_full; the K4 launches of the three
                 processes beside the warm in-process proof's and three
                 times the MSM engine's per-process set-up
  honk_small     co-noir at a small size (circuits built in code by
                 tests/torch_port_util.py): the co-ACVM under REP3 on a
                 circuit with a ROM block read at a shared index and a RAM
                 block written and read at shared indices (Rep3Lut), opened
                 and held to PlainNoirDriver's witness; from its shares a
                 REP3 co-UltraHonk proof (provider mode: LUT reads and
                 writes and oblivious sorts in the builder), and REP3 and
                 Shamir proofs of a 16-gate squaring chain, each byte-equal
                 to the port's plain prover, verified, a changed public
                 input refused; a FileCrs commit of 64 coefficients through
                 driver_msm equal to TestCrs.commit (K5 must launch)
  honk_full      co-UltraHonk under REP3 at n = 2^20 rows (--honk-log): a
                 Poseidon-style permutation chain (x^5 S-boxes as multiply
                 gates, a width-4 linear layer as quad gates, 65,534
                 rounds, 13 padding rows) from a seed; three party threads,
                 each building its own circuit and keys on the host, once
                 (noir_cli's three processes prove the same circuit again);
                 party 0's spans (builder, keys, the oink rounds, sumcheck,
                 zeromorph and KZG), rounds and bytes, peak device memory,
                 launches (K1 and K4 must show); the vk by create_keys with
                 TestCrs evaluating on the card; the host verifier accepts
                 and refuses a changed public input
  noir_cli       the noir CLI (python -m cocircom_tpu_torch.noir.cli) as
                 separate party processes over mutual-TLS meshes: every
                 subcommand on the small circuits (split-input by two
                 providers, merge-input-shares, generate-witness,
                 translate-witness, split-witness, generate-proof, create-vk,
                 verify, a changed public input refused), then honk_full's
                 chain written as an ACIR program JSON and a witness stack,
                 split-witness and three generate-proof processes at 2^20
                 with create-vk beside them: proofs byte-equal and verified;
                 each party's spans, bytes, peak memory and launches
  graft          graft_entry.entry() and graft_entry.dryrun_multichip(2)
The launch counts are set to 0 just before each phase's first 3-party proof
and read just after it, so they hold the proving paths alone (the cli
phase's are those its generate-proof processes report, each from 0 where
its proof starts; what a process launched before that, reading its zkey,
is reported apart as `launches_setup`); a line
{"phase": "launches", ...} gives each proof's counts apart.  Then one line
{"kernels": [...]} whose launches are their sum, the nvidia-smi line, and as
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Options (for shorter measurement runs):
  --phases a,b,..   run only these phases (the final ok line is printed only
                    after a full run).  One more phase runs only when named
                    here: `honk_profile`, one honk_full proof at
                    2^--honk-log rows under torch.profiler: the card's busy
                    share and the device time by kernel
  --full-log N      size of prove_full, prove_sharded and prove_shamir (default
                    20; never below 18)
  --honk-log N      rows (log2) of honk_full and noir_cli's full proof
                    (default 20)

Integer peak used for the bound: the card's table gives 67 TFLOP/s float32
outside the tensor cores, i.e. 33.5e12 fused multiply-adds a second on 128
lanes per SM; 32-bit integer multiply-adds issue on half as many lanes, so
16.75e12 a second.  Memory rate: 3.35e12 bytes a second.  A Montgomery
product of L limbs counts 2*L*L + L multiply-adds, a squaring
L*(L+1)/2 + L*L + L, an Fq2 product 3*L*L + 2*(L*L + L) (Karatsuba, one
reduction a component).  A complete add (RCB16 Alg. 7) is 12 products and
two by b3; where b3 is a small integer (both G1s, BLS12-381's G2) those two
are a few modular adds and count nothing.  The mixed add (madd-2007-bl) is 7
products and 4 squarings.  An NTT of 2^m points counts m 2^(m-1) - (2^m - 1)
products (the radix-2 network less its 2^m - 1 butterflies by w^0 = 1, which
need none: 4,097 at 2^10, not 5,120),
plus one an element for a factor table or the 1/n of an inverse; its bytes
are each input, table and output once, so a 2^20 transform counts its two
column passes, one product an element (the four-step factor) and five
arrays of 2^20 elements (x, the factor table, the intermediate written and
read, the output).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

MEM_RATE = 3.35e12
INT_MAD_RATE = 16.75e12

SMALL_MULS = 300  # constraints of prove_small's multiplier chain
BLS_MULS = 100    # constraints of prove_bls's multiplier chain
PLONK_SMALL_MULS = 200  # chain gates of plonk_small over BN254 (domain 256)
PLONK_LOG = 18          # gates (log2) of plonk_full's chain: cut from 2^20 so the whole
                        # script, with the co-noir phases, stays within its time limit

ALL_PHASES = ("build", "device", "kernels", "prove_small", "prove_full", "prove_sharded",
              "prove_shamir", "prove_bls", "plonk_small", "plonk_full", "vm_small", "vm_full",
              "cli", "honk_small", "honk_full", "noir_cli", "graft")
OPTIONAL_PHASES = ("honk_profile",)


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also gets `t_s`, the seconds since
    the script started, so the lines give each phase's share of the run."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
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
    """Uniform canonical Montgomery elements made from `gen`, on its device."""
    shape = (f.L,) + tuple(n_shape)
    raw = torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64, device=gen.device)
    raw[f.L - 1] &= (1 << (f.bits - 32 * (f.L - 1))) - 1
    return f._cond_sub_p(raw.to(torch.int32).to(f.device))


def columns_plain(f, x, tw, post=None, transpose: bool = False, piece: int = 1 << 20):
    """ntt_columns_plain of the whole of x, computed over pieces of at most
    `piece` elements: ranges of columns, or with a factor table ranges of v
    with all their B columns (the plain version's temporaries are some
    thousand bytes an element)."""
    from cocircom_tpu_torch.ops.ntt import ntt_columns_plain

    L, M, cols = x.shape
    if post is None:
        step = max(1, piece // M)
        y = torch.cat([ntt_columns_plain(f, x[:, :, c:c + step], tw)
                       for c in range(0, cols, step)], dim=2)
        return y.reshape(L, 1, M * cols) if transpose else y
    V = post.shape[2]
    B = cols // V
    step = max(1, piece // (M * B))
    return torch.cat([ntt_columns_plain(f, x[:, :, v * B:(v + step) * B], tw,
                                        post[:, :, v:v + step], transpose)
                      for v in range(0, V, step)], dim=1 if transpose else 2)


def plain_transform(eng, a, inverse: bool):
    """The NTT engine's transform of (L, n) `a`, n above one ntt_columns
    call, from the plain version of each of its levels: the same four-step
    recursion, twiddles and factor tables (the 1/n of an inverse in the top
    table)."""
    L, n = a.shape
    logn = n.bit_length() - 1
    assert logn > eng.KMAX

    def level(x, logm, scale):
        if logm <= eng.KMAX:
            return columns_plain(eng.f, x, eng._twiddles(logm, inverse))
        B = x.shape[2]
        logu = min(eng.KMAX, logm - 1)
        U, V = 1 << logu, 1 << (logm - logu)
        y = columns_plain(eng.f, x.reshape(L, U, V * B), eng._twiddles(logu, inverse),
                          eng._fourstep_table(logm, logu, inverse, scale), transpose=True)
        return level(y, logm - logu, None).reshape(L, V * U, B)

    return level(a[:, :, None], logn, logn if inverse else None).reshape(L, n)


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


def run_proof(make_prover, zkey, shares, traced: bool):
    """Three party threads over the in-process network, party i proving
    shares[i] with make_prover(net, tracer); returns (proofs, wall seconds,
    per-span seconds of party 0)."""
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.utils.trace import Tracer

    rows = []

    def party(i, net):
        tracer = Tracer(enabled=traced and i == 0, net=net, sync=torch.cuda.synchronize)
        proof = make_prover(net, tracer).prove(zkey, shares[i])
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


def prove_rep3(curve, zkey, shares, device, traced: bool, devices=None):
    """A 3-party REP3 co-Groth16 proof (run_proof).  With `devices` the
    parties' drivers are built with that list (the sharded engines)."""
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
    from cocircom_tpu_torch.snark.groth16 import CoGroth16

    where = {"device": device} if devices is None else {"devices": devices}
    return run_proof(lambda net, tr: CoGroth16(Rep3Driver(curve, net, **where), tr),
                     zkey, shares, traced)


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
    from cocircom_tpu_torch.ops.field import add_plain, get_field, mont_mul_plain, sub_plain
    from cocircom_tpu_torch.ops.msm import MSM
    from cocircom_tpu_torch.ops.ntt import (ntt_columns, ntt_columns_plain, ntt_engine,
                                            ntt_small, ntt_small_plain, power_table)

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

    # ---- field_add: add and sub mod p at the paths' shapes, over both
    # fields of the curve, against add_plain / sub_plain: (L, 2^20) pairs
    # (the Groth16 quotient's a b - c; the row's ms, a sub), one operand a
    # single element, (L, 2^17) negations (the MSM's signed affine rows of a
    # chunk), and the co-UltraHonk sumcheck's (L, 8, 2^15) edge tensors of
    # 2^16 rows, with a public constant (L, 1, 1) broadcast either side;
    # edge values in every operand ----
    def add_cases(f):
        n, e = 1 << 20, 1 << 15
        a, b = rand_field(f, (n,), gen), rand_field(f, (n,), gen)
        a[:, :64] = edge(f, 64)
        b[:, :64] = edge(f, 64).roll(1, dims=1)
        ea, eb = rand_field(f, (8, e), gen), rand_field(f, (8, e), gen)
        ea[:, :, :64] = edge(f, 8 * 64).reshape(f.L, 8, 64)
        eb[:, :, :64] = ea[:, :, :64].roll(1, dims=2)
        one = eb[:, 3:4, 7:8].contiguous()
        chunk = a[:, : 1 << 17]
        return [(a, b), (a, b[:, 5:6].contiguous()), (torch.zeros_like(chunk), chunk),
                (ea, eb), (ea, one), (one, ea)]

    err = 0
    for f in (fr, fq):
        for x, y in add_cases(f):
            err = max(err, max_err(f.add(x, y), add_plain(f, x, y)),
                      max_err(f.sub(x, y), sub_plain(f, x, y)))
    check(err == 0, f"field_add (L={L}) disagrees with add_plain / sub_plain (max abs err {err})")
    (a, b), _, _, (ea, eb), (_, one), _ = add_cases(f1)
    n, ne = a.shape[1], eb.numel() // L
    edges = {
        "shape": [L, 8, ne // 8],
        "ms": time_cuda(lambda: f1.add(ea, eb), 200),
        "plain_ms": timed_plain(lambda: add_plain(f1, ea, eb)),
        "bound_ms": bound(3 * W * ne, 0)[0],
        "ms_constant": time_cuda(lambda: f1.sub(ea, one), 200),
        "bound_ms_constant": bound(2 * W * ne + W, 0)[0]}
    ms = time_cuda(lambda: f1.sub(a, b), 50)
    pms = timed_plain(lambda: sub_plain(f1, a, b))
    record("field_add", "field_add.cu", None, err, ms, pms, 3 * W * n, 0, [L, n],
           honk_edges=edges)
    del a, b, ea, eb, one

    # ---- K2 ntt_butterfly: a whole transform below 2^12 points, one launch:
    # 2^9 (prove_small's domain: the row's ms) and 2^11 (the largest the
    # small path takes), forward and inverse (1/n), against the per-stage
    # plain version; sizes 2^1-2^5 and edge values in every input ----
    def scale_of(f, logn):
        """The 1/n of an inverse transform over Fr; 3 over Fq."""
        return ntt_engine(fr, curve.fr)._n_inv(logn) if f is fr else f.encode([3])

    def small_input(f, logn):
        a = rand_field(f, (1 << logn,), gen)
        k = min(64, 1 << logn)
        a[:, :k] = edge(f, k)
        return a

    def small_case(f, logn, inverse):
        """(input, twiddles, scale) of one small transform."""
        return (small_input(f, logn), twiddles(f, logn, inverse),
                scale_of(f, logn) if inverse else None)

    def check_small(f, logns):
        err = 0
        for logn in logns:
            for inverse in (False, True):
                a, tws, sc = small_case(f, logn, inverse)
                err = max(err, max_err(ntt_small(f, a, tws, sc), ntt_small_plain(f, a, tws, sc)))
        return err

    def ntt_products(logm):
        """Products a 2^logm-point transform needs: its radix-2 network
        less the 2^logm - 1 butterflies by w^0 = 1."""
        return logm * (1 << (logm - 1)) - ((1 << logm) - 1)

    def small_work(logn, inverse):
        """(bytes, multiply-adds): input, output and twiddles (and the
        scale) once; the transform's products (and n for the 1/n)."""
        n = 1 << logn
        return (2 * W * n + W * (n // 2) + (W if inverse else 0),
                (ntt_products(logn) + (n if inverse else 0)) * mpm)

    err = check_small(f1, (1, 2, 3, 4, 5, 9, 11))
    check(err == 0, f"ntt_butterfly (L={L}) disagrees with ntt_small_plain (max abs err {err})")
    transforms = []
    for logn in (9, 11):
        for inverse in (False, True):
            a, tws, sc = small_case(f1, logn, inverse)
            transforms.append({
                "log_n": logn, "inverse": inverse,
                "ms": time_cuda(lambda: ntt_small(f1, a, tws, sc), 200),
                "plain_ms": timed_plain(lambda: ntt_small_plain(f1, a, tws, sc)),
                "bound_ms": bound(*small_work(logn, inverse))[0]})
    record("ntt_butterfly", "ntt_butterfly.cu", "cocircom_tpu/ops/pallas_field.py:502", err,
           transforms[0]["ms"], transforms[0]["plain_ms"], *small_work(9, False), [L, 1 << 9],
           transforms=transforms)

    # ---- K3 ntt_columns at (L, 1024, 1024): the column pass alone (the
    # second level of a 2^20 transform; the row's ms), the fused pass (the
    # first level: times the four-step table, stored transposed), and over
    # Fr whole 2^20 transforms through the engine, forward and inverse, two
    # launches each and nothing else; ragged column counts and edge values
    # (logm, V, B, with a factor table, transposed; V = 1 without a table);
    # over Fr, the three level shapes of a 2^22 transform ----
    def check_columns(f, shapes):
        err = 0
        for logm, V, B, with_post, transpose in shapes:
            M = 1 << logm
            xs = rand_field(f, (M, V * B), gen)
            k = min(M, 8)
            xs[:, :k, 0] = edge(f, k)
            tws = twiddles(f, logm, True)
            pt = rand_field(f, (M, V), gen) if with_post else None
            err = max(err, max_err(ntt_columns(f, xs, tws, pt, transpose),
                                   columns_plain(f, xs, tws, pt, transpose)))
        return err

    ragged = ((1, 5, 1, 1, 1), (2, 3, 3, 1, 1), (2, 1, 9, 0, 1), (3, 7, 1, 1, 0), (4, 1, 3, 0, 0),
              (5, 2, 3, 1, 1), (9, 64, 1, 1, 1), (9, 3, 7, 1, 1), (10, 9, 7, 1, 1),
              (10, 1, 64, 0, 0), (10, 5, 1, 1, 0))
    M, B = 1 << 10, 1 << 10
    tw = twiddles(f1, 10)
    x = rand_field(f1, (M, B), gen)
    x[:, :8, :8] = edge(f1, 64).reshape(L, 8, 8)
    eng_fr = ntt_engine(fr, curve.fr)
    tbl = eng_fr._fourstep_table(20, 10, False, None) if f1 is fr else rand_field(f1, (M, B), gen)
    got = ntt_columns(f1, x, tw)
    err = max_err(got, ntt_columns_plain(f1, x, tw))
    fused = ntt_columns(f1, x, tw, tbl, transpose=True)
    err = max(err, max_err(fused, ntt_columns_plain(f1, x, tw, tbl, transpose=True)))
    err = max(err, check_columns(f1, ragged))
    check(err == 0, f"ntt_columns (L={L}) disagrees with ntt_columns_plain (max abs err {err})")
    col_work = (2 * W * M * B + W * (M // 2), ntt_products(10) * B * mpm)
    fused_work = (col_work[0] + W * M * B, col_work[1] + M * B * mpm)
    extra = {"fused_pass": {
        "ms": time_cuda(lambda: ntt_columns(f1, x, tw, tbl, transpose=True), 10),
        "plain_ms": timed_plain(lambda: ntt_columns_plain(f1, x, tw, tbl, transpose=True)),
        "bound_ms": bound(*fused_work)[0], "bound_by": bound(*fused_work)[1]}}
    ms = time_cuda(lambda: ntt_columns(f1, x, tw), 10)
    pms = timed_plain(lambda: ntt_columns_plain(f1, x, tw))
    del x, got, fused
    if f1 is fr:
        n = M * B
        xa = rand_field(fr, (n,), gen)
        xa[:, :64] = edge(fr, 64)

        whole = []
        for inverse in (False, True):
            run = eng_fr.intt if inverse else eng_fr.ntt
            run(xa)                              # builds the tables (K1 launches)
            before = kernels.launch_counts()
            got = run(xa)
            after = kernels.launch_counts()
            launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            check(launched == {"ntt_columns": 2},
                  f"a 2^20 {'inverse ' if inverse else ''}transform launched {launched}, "
                  "not two ntt_columns")
            err = max(err, max_err(got, plain_transform(eng_fr, xa, inverse)))
            work = (5 * W * n + 2 * W * (M // 2), 2 * col_work[1] + n * mpm)
            whole.append({"log_n": 20, "inverse": inverse, "launches": 2,
                          "ms": time_cuda(lambda: run(xa), 10),
                          "plain_ms": timed_plain(lambda: plain_transform(eng_fr, xa, inverse)),
                          "bound_ms": bound(*work)[0], "bound_by": bound(*work)[1]})
        check(err == 0, f"a 2^20 transform (L={L}) disagrees with its plain decomposition")
        # the decomposition itself against the per-stage network at 2^20
        check(torch.equal(eng_fr.ntt(xa), ntt_small_plain(fr, xa, eng_fr._twiddles(20, False))),
              "the four-step 2^20 transform disagrees with the per-stage network")
        check(torch.equal(eng_fr.intt(eng_fr.ntt(xa)), xa), "intt(ntt(x)) != x at 2^20")
        extra["transforms"] = whole
        del xa, got
        # the three levels of a 2^22 transform (PLONK's extended domain):
        # (1024, V = 4096) with its factor table, (1024, V = 4, B = 1024),
        # 4 points over 2^20 columns
        err = check_columns(fr, ((10, 4096, 1, 1, 1), (10, 4, 1024, 1, 1), (2, 1, n, 0, 0)))
        check(err == 0, f"ntt_columns disagrees with ntt_columns_plain at a 2^22 level "
                        f"(max abs err {err})")
    record("ntt_columns", "ntt_columns.cu", "cocircom_tpu/ops/pallas_ntt.py:223", err, ms, pms,
           *col_work, [L, M, B], **extra)

    if f1 is not fr:
        # this curve's Fr: the 8-limb builds with another modulus and root tower
        err = max(check_small(fr, (3, 9, 11)),
                  check_columns(fr, ((4, 3, 1, 1, 1), (10, 9, 7, 1, 1), (10, 1, 5, 0, 0))))
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
                      ("name", "ms", "plain_ms", "bound_ms", "bound_by", "shape", "fused_pass",
                       "transforms")}
                     for r in out],
          "launches_during_checks": kernels.launch_counts()})
    return out


# -------------------------------------------------------- phase: prove_small

@contextlib.contextmanager
def transform_sizes():
    """Records the size of every transform the one-device NTT engines run
    (NTTEngine._transform, wrapped while the context is open)."""
    from cocircom_tpu_torch.ops.ntt import NTTEngine

    sizes, inner = [], NTTEngine._transform

    def counted(self, a, inverse):
        sizes.append(a.shape[1])
        return inner(self, a, inverse)

    NTTEngine._transform = counted
    try:
        yield sizes
    finally:
        NTTEngine._transform = inner


def phase_prove_small(curve, device, n_mul: int) -> dict:
    """Returns the launch counts of the 3-party proof alone."""
    from cocircom_tpu_torch.ops import kernels

    zkey, vk, shares, publics, setup_s = small_inputs(curve, device, n_mul, b"chip_smoke")
    with transform_sizes() as sizes:
        kernels.reset_launch_counts()
        proofs, wall, _ = prove_rep3(curve, zkey, shares, device, traced=False)
        counts = kernels.launch_counts()
    check_small_proofs("prove_small", vk, proofs, publics)
    # 3 parties x 2 share components x (3 iFFT + 3 FFT), each one K2 launch
    check(sizes == [zkey.domain_size] * 36 and counts["ntt_butterfly"] == 36
          and counts["ntt_columns"] == 0,
          f"prove_small: {len(sizes)} transforms took {counts['ntt_butterfly']} ntt_butterfly "
          f"and {counts['ntt_columns']} ntt_columns launches, not one ntt_butterfly each")
    emit({"phase": "prove_small", "constraints": n_mul,
          "domain": zkey.domain_size, "setup_s": round(setup_s, 2),
          "prove_s": round(wall, 3), "verified": True, "tamper_rejected": True,
          "transforms": len(sizes), "ntt_butterfly": counts["ntt_butterfly"]})
    return counts


def small_inputs(curve, device, n_mul: int, seed: bytes, shamir: bool = False):
    """The hand-built multiplier chain over `curve` through the real setup
    and the real loader: (zkey, vk, the parties' REP3 shares, or Shamir
    shares (t = 1) with `shamir`, publics, seconds the host-side setup
    took)."""
    from cocircom_tpu_torch.io.r1cs import multiplier_chain
    from cocircom_tpu_torch.io.witness import Witness
    from cocircom_tpu_torch.io.zkey import read_groth16_zkey
    from cocircom_tpu_torch.ops.field import ints_to_limbs_np
    from cocircom_tpu_torch.snark.setup import groth16_setup
    from cocircom_tpu_torch.snark.shared import split_witness_rep3, split_witness_shamir

    t0 = time.perf_counter()
    r1cs, vals = multiplier_chain(curve, n_mul, 3)
    zkey_bytes, vk = groth16_setup(r1cs, seed=seed)
    setup_s = time.perf_counter() - t0
    zkey = read_groth16_zkey(zkey_bytes, device=device)
    check(zkey.curve is curve, "the loader did not find the zkey's curve")
    wit = Witness(curve, len(vals), ints_to_limbs_np(vals, -(-curve.fr.bits // 32)))
    if shamir:
        shares = split_witness_shamir(wit, 2, 1, 3, seed=7, device=device)
    else:
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


def phase_prove_full(curve, device, log_n: int, inputs) -> tuple:
    """Returns the launch counts of the cold 3-party proof alone, the warm
    proof's wall seconds and the warm proof's launch counts."""
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.curve import pmap
    from cocircom_tpu_torch.ops.field import get_field

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    gen = torch.Generator().manual_seed(4343)
    zkey, k_a, k_b2, shares, build_s = inputs

    torch.cuda.reset_peak_memory_stats()
    with transform_sizes() as sizes:
        kernels.reset_launch_counts()
        proofs, cold, spans_cold = prove_rep3(curve, zkey, shares, device, traced=True)
        counts_cold = kernels.launch_counts()
    kernels.reset_launch_counts()
    proofs_w, warm, spans_warm = prove_rep3(curve, zkey, shares, device, traced=True)
    counts_warm = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(proofs[0] == proofs[1] == proofs[2], "prove_full: the parties' proofs differ")
    check(proofs_w[0] == proofs_w[1] == proofs_w[2], "prove_full: warm proofs differ")
    check(on_curve(curve, proofs[0]) and on_curve(curve, proofs_w[0]),
          "prove_full: a proof point is not on its curve")
    check(counts_cold["ec_wave_add_g2"] > 0, "prove_full: ec_wave_add_g2 was never launched")
    # the witness map's 36 transforms of 2^20 points: two K3 launches each
    check(sizes == [zkey.domain_size] * 36 and counts_cold["ntt_columns"] == 2 * len(sizes)
          and counts_cold["ntt_butterfly"] == 0,
          f"prove_full: {len(sizes)} transforms took {counts_cold['ntt_columns']} ntt_columns "
          "launches, not two each")

    # NTT round trip at the size the witness map uses; each transform two
    # ntt_columns launches and no mont_mul (the four-step factor is in the
    # first launch)
    d = PlainDriver(curve, device=device)
    x = rand_field(fr, (zkey.domain_size,), gen)
    kernels.reset_launch_counts()
    y = d.ntt.ntt(x)
    fwd = kernels.launch_counts()
    kernels.reset_launch_counts()
    check(torch.equal(d.ntt.intt(y), x), "prove_full: intt(ntt(x)) != x")
    inv = kernels.launch_counts()
    for c in (fwd, inv):
        check({k: v for k, v in c.items() if v} == {"ntt_columns": 2},
              f"prove_full: a 2^20 transform launched {({k: v for k, v in c.items() if v})}")

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
          "transforms": len(sizes), "ntt_columns": counts_cold["ntt_columns"],
          "proofs_identical": True, "on_curve": True})
    return counts_cold, round(warm, 3), counts_warm


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


# ------------------------------------------------------- phase: prove_shamir

def shamir_groth16(curve, device):
    """make_prover for run_proof: co-Groth16 over a Shamir driver, t = 1."""
    from cocircom_tpu_torch.mpc.shamir import ShamirDriver
    from cocircom_tpu_torch.snark.groth16 import CoGroth16

    return lambda net, tr: CoGroth16(ShamirDriver(curve, net, 1, device=device), tr)


def phase_prove_shamir(curve, device, log_n: int, inputs) -> dict:
    """3-party Shamir co-Groth16 (t = 1): prove_small's chain (verified), then
    prove_full's synthetic zkey with the REP3 shares translated to Shamir;
    before that proof the translated witness and a full-length product of
    it are opened and held to the REP3-opened witness.  Returns the launch
    counts of the full-sized proof alone."""
    from cocircom_tpu_torch.mpc.bridges import translate_rep3_to_shamir
    from cocircom_tpu_torch.mpc.rep3 import combine_field_shares
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.mpc.shamir import ShamirDriver
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.snark.groth16 import SharedWitness

    zkey, vk, shares, publics, _ = small_inputs(curve, device, SMALL_MULS, b"chip_smoke",
                                                shamir=True)
    proofs, wall_small, _ = run_proof(shamir_groth16(curve, device), zkey, shares, traced=False)
    check_small_proofs("prove_shamir", vk, proofs, publics)

    zkey, _, _, rep3_shares, _ = inputs
    t0 = time.perf_counter()
    shares = run_parties(lambda i, net: SharedWitness(
        rep3_shares[i].public_inputs,
        translate_rep3_to_shamir(curve, net, rep3_shares[i].witness, 1)), 3)
    torch.cuda.synchronize()
    translate_s = time.perf_counter() - t0

    # the translated witness w and one full-length product w * roll(w)
    # (DN07 pairs, king reduction, r_2t added in place), opened, against
    # the REP3-opened witness
    def opened(i, net):
        d = ShamirDriver(curve, net, 1, device=device)
        w = shares[i].witness
        return d.open_many(w), d.open_many(d.mul_vec(w, w.roll(1, dims=1)))

    t0 = time.perf_counter()
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    w = combine_field_shares(fr, [s.witness for s in rep3_shares])
    ww = fr.mont_mul(w, w.roll(1, dims=1))
    for ow, oww in run_parties(opened, 3):
        check(torch.equal(ow, w), "prove_shamir: the translated witness opens to another one")
        check(torch.equal(oww, ww), "prove_shamir: a full-length Shamir product opens wrong")
    del w, ww
    open_check_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    proofs, wall, spans = run_proof(shamir_groth16(curve, device), zkey, shares, traced=True)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(proofs[0] == proofs[1] == proofs[2], "prove_shamir: the parties' proofs differ")
    check(on_curve(curve, proofs[0]), "prove_shamir: a proof point is not on its curve")
    check(counts["ec_wave_add_g2"] > 0, "prove_shamir: ec_wave_add_g2 was never launched")
    emit({"phase": "prove_shamir", "threshold": 1, "small_constraints": SMALL_MULS,
          "small_prove_s": round(wall_small, 3), "small_verified": True,
          "small_tamper_rejected": True, "log_n": log_n,
          "constraints": zkey.matrices.num_constraints, "translate_s": round(translate_s, 3),
          "open_check_s": round(open_check_s, 3),
          "prove_s": round(wall, 3), "spans_party0": spans, "peak_device_bytes": int(peak),
          "launches": {k: v for k, v in counts.items() if v},
          "proofs_identical": True, "on_curve": True})
    return counts


# -------------------------------------------------------- phase: plonk_small



@contextlib.contextmanager
def insecure_deterministic():
    """COCIRCOM_INSECURE_DETERMINISTIC=1 for the proofs inside only."""
    os.environ["COCIRCOM_INSECURE_DETERMINISTIC"] = "1"
    try:
        yield
    finally:
        del os.environ["COCIRCOM_INSECURE_DETERMINISTIC"]


def plonk_makers(curve, device) -> dict:
    """{protocol: make_driver(net)} for the three protocols (Plain ignores
    the network: its proof runs in each thread alone)."""
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
    from cocircom_tpu_torch.mpc.shamir import ShamirDriver

    return {"plain": lambda net: PlainDriver(curve, device=device),
            "rep3": lambda net: Rep3Driver(curve, net, device=device),
            "shamir": lambda net: ShamirDriver(curve, net, 1, device=device)}


def plonk_prove(proto: str, make_driver, zk, shares, deterministic=False, traced=False):
    """run_proof with CoPlonk over make_driver(net): (proofs, wall, spans).
    A Plain proof runs once, in this thread, and stands for all three."""
    from cocircom_tpu_torch.snark.plonk import CoPlonk

    if proto != "plain":
        return run_proof(lambda net, tr: CoPlonk(make_driver(net), deterministic, tr),
                         zk, shares, traced)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = CoPlonk(make_driver(None), deterministic).prove(zk, shares[0])
    torch.cuda.synchronize()
    return [proof] * 3, time.perf_counter() - t0, {}


def plonk_small_curve(curve, n_mul: int, device, protocols) -> tuple:
    """The chain with one two-term side over `curve` through the port's
    plonk_setup and reader; a proof under each protocol, verified, and with
    deterministic blinding the proofs' JSON byte-equal.  Returns (summary,
    launch counts of the REP3 proof)."""
    from cocircom_tpu_torch.io.jsonio import dump_plonk_proof
    from cocircom_tpu_torch.io.plonk_zkey import read_plonk_zkey
    from cocircom_tpu_torch.io.r1cs import multiplier_chain
    from cocircom_tpu_torch.io.witness import Witness
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.field import get_field, ints_to_limbs_np
    from cocircom_tpu_torch.snark.groth16 import SharedWitness
    from cocircom_tpu_torch.snark.plonk_setup import plonk_setup
    from cocircom_tpu_torch.snark.plonk_verify import verify_plonk
    from cocircom_tpu_torch.snark.shared import split_witness_rep3, split_witness_shamir

    t0 = time.perf_counter()
    r1cs, vals = multiplier_chain(curve, n_mul, 3)
    s = len(vals)   # one more constraint: (a + x3) * 1 = s, a two-term side
    vals = vals + [(vals[2] + vals[3]) % curve.fr.p]
    r1cs.constraints.append(([(2, 1), (3, 1)], [(0, 1)], [(s, 1)]))
    r1cs.n_wires = r1cs.n_labels = len(vals)
    r1cs.n_constraints += 1
    zkey_bytes, vk = plonk_setup(r1cs, seed=b"chip_smoke_plonk")
    setup_s = time.perf_counter() - t0
    zk = read_plonk_zkey(zkey_bytes, device=device)
    check(zk.n_additions == 1 and zk.curve is curve,
          f"plonk_small: the {curve.name} zkey has {zk.n_additions} additions, not 1")
    publics = [vals[1], vals[2]]
    wit = Witness(curve, len(vals), ints_to_limbs_np(vals, -(-curve.fr.bits // 32)))
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    shares = {"plain": [SharedWitness(vals[:3], fr.encode(vals[3:]))] * 3,
              "rep3": split_witness_rep3(wit, 2, seed=8, device=device),
              "shamir": split_witness_shamir(wit, 2, 1, 3, seed=9, device=device)}
    makers = plonk_makers(curve, device)
    walls, counts, jsons = {}, None, {}
    for proto in protocols:
        with transform_sizes() as sizes:
            kernels.reset_launch_counts()
            proofs, wall, _ = plonk_prove(proto, makers[proto], zk, shares[proto])
            c = kernels.launch_counts()
        walls[proto] = round(wall, 3)
        check(proofs[0] == proofs[1] == proofs[2], f"plonk_small: {proto} proofs differ")
        check(verify_plonk(vk, proofs[0], publics),
              f"plonk_small: verify_plonk refused the {curve.name} {proto} proof")
        check(not verify_plonk(vk, proofs[0], [publics[0], publics[1] + 1]),
              f"plonk_small: verify_plonk accepted a changed public input ({proto})")
        # every transform is below 2^12 points: one ntt_butterfly launch each
        check(c["ntt_butterfly"] == len(sizes) > 0 and c["ntt_columns"] == 0,
              f"plonk_small: {len(sizes)} transforms took {c['ntt_butterfly']} ntt_butterfly "
              f"and {c['ntt_columns']} ntt_columns launches, not one ntt_butterfly each")
        if proto == "rep3":
            counts = c
        with insecure_deterministic():
            det, _, _ = plonk_prove(proto, makers[proto], zk, shares[proto], deterministic=True)
        check(verify_plonk(vk, det[0], publics),
              f"plonk_small: verify_plonk refused the deterministic {proto} proof")
        jsons[proto] = dump_plonk_proof(curve, det[0])
    check(len(set(jsons.values())) == 1,
          f"plonk_small: the deterministic {curve.name} proofs' JSON differ between protocols")
    return ({"curve": curve.name, "gates": zk.n_constraints, "domain": zk.domain_size,
             "additions": zk.n_additions, "setup_s": round(setup_s, 2), "prove_s": walls,
             "verified": True, "tamper_rejected": True, "deterministic_json_equal": True},
            counts)


def phase_plonk_small(device) -> dict:
    """plonk_small_curve over BN254 (Plain, REP3, Shamir) and over
    BLS12-381 (Plain, REP3).  Returns the launch counts of the two REP3
    proofs."""
    from cocircom_tpu_torch.fields.params import BLS12_381, BN254

    bn, counts = plonk_small_curve(BN254, PLONK_SMALL_MULS, device, ("rep3", "plain", "shamir"))
    bls, counts_bls = plonk_small_curve(BLS12_381, BLS_MULS, device, ("rep3", "plain"))
    total = {k: counts[k] + counts_bls[k] for k in counts}
    emit({"phase": "plonk_small", "bn254": bn, "bls12_381": bls,
          "launches": {k: v for k, v in total.items() if v}})
    return total


# --------------------------------------------------------- phase: plonk_full

def columns_launches(logn: int) -> int:
    """ntt_columns launches of one 2^logn transform (logn >= 12): one per
    level of the four-step recursion."""
    from cocircom_tpu_torch.ops.kernels import NTT_COLUMNS_MAX_LOG as kmax

    k, m = 1, logn
    while m > kmax:
        m -= min(kmax, m - 1)
        k += 1
    return k


def plonk_key(curve, log_n: int, device, seed: int):
    """The PLONK zkey and vk of a 2^log_n-gate multiplier chain (two
    public-input gates, then y = a^(n-1) in n - 2 multiplication gates),
    built on the device with a real tau drawn from `seed`: p_tau by a batched
    scalar multiplication, the selector and sigma evaluations from the gate
    layout and the copy cycles (plonk_setup's orientation), coefficients by
    the iNTT, the 4n evaluations by the NTT, commitments by the MSM.
    Returns (zkey, vk, publics, aux witness (L, n - 3) Montgomery)."""
    from cocircom_tpu_torch.io.plonk_zkey import CircomPoly, PlonkZKey
    from cocircom_tpu_torch.io.zkey import G1Array
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.ops.curve import g1_ops, pmap
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.ops.msm import msm_engine
    from cocircom_tpu_torch.ops.ntt import ntt_engine, power_table

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    g1 = g1_ops(curve, device)
    eng = ntt_engine(fr, curve.fr)
    p = fr.p
    n = 1 << log_n
    n_mul = n - 2
    rng = np.random.default_rng(seed)
    tau = int.from_bytes(rng.bytes(48), "little") % p
    k1, k2 = 2, 3

    # gates: rows 0, 1 are the public inputs (wires 1, 2; ql = 1); row 2 + k
    # multiplies wire k + 2 (a for k = 0) by a into wire k + 3 (1 for the last)
    g = np.arange(n_mul, dtype=np.int64)
    maps = [np.concatenate([[1, 2], g + 2]), np.concatenate([[0, 0], np.full(n_mul, 2)]),
            np.concatenate([[0, 0], np.where(g == n_mul - 1, 1, g + 3)])]
    vals = fr.encode([0, 1, p - 1])                       # selector values
    chain = np.r_[0, 0, np.ones(n_mul, np.int64)]
    pick = lambda idx: vals.index_select(1, torch.from_numpy(idx).to(fr.device))  # noqa: E731
    qm, qo = pick(chain), pick(2 * chain)
    ql, zero = pick(np.r_[1, 1, np.zeros(n_mul, np.int64)]), fr.zeros((n,)).contiguous()

    # sigma: in the scan order (row, then a, b, c) each slot points at the
    # previous slot of its wire, the first one at the last
    sig = np.stack(maps, axis=1).reshape(-1)
    pos = (np.arange(3)[None, :] * n + np.arange(n)[:, None]).reshape(-1)
    order = np.argsort(sig, kind="stable")
    srt = sig[order]
    start = np.r_[True, srt[1:] != srt[:-1]]
    grp = np.cumsum(start) - 1
    last = np.r_[np.nonzero(start)[0][1:], len(order)] - 1
    prev = np.arange(len(order)) - 1
    prev[start] = last[grp[start]]
    src = np.empty(3 * n, np.int64)
    src[pos[order]] = pos[order[prev]]
    w = power_table(fr, curve.fr.root_of_unity(log_n), n)
    ident = torch.cat([w, fr.mont_mul(w, fr.const_mont(k1)[:, None]),
                       fr.mont_mul(w, fr.const_mont(k2)[:, None])], dim=1)
    sigma = ident.index_select(1, torch.from_numpy(src).to(fr.device))
    del ident
    lag = []
    for i in range(2):
        e = fr.zeros((n,)).clone()
        e[:, i] = fr.const_mont(1)
        lag.append(e)

    def poly(evals):
        coeffs = eng.intt(evals.contiguous())
        ext = torch.cat([coeffs, fr.zeros((3 * n,))], dim=1)
        return CircomPoly(coeffs, eng.ntt(ext))

    polys = {name: poly(e) for name, e in (("qm", qm), ("ql", ql), ("qr", zero), ("qo", qo),
                                           ("qc", zero), ("s1", sigma[:, :n]),
                                           ("s2", sigma[:, n:2 * n]), ("s3", sigma[:, 2 * n:]))}
    del sigma, qm, qo, ql
    # p_tau[i] = tau^i G1, i < n + 6
    scal = fr.from_mont(power_table(fr, tau, n + 6))
    pts = g1.scalar_mul(g1.encode_points([curve.g1_gen]), scal)
    ax, ay = g1.to_affine_limbs(pts)
    del pts, scal
    p_tau = G1Array(ax.contiguous(), ay.contiguous())
    msm = msm_engine(g1, scalar_bits=curve.fr.p.bit_length())
    ptau_n = pmap(lambda c: c[:, :n], PlainDriver(curve, device=device).g1_proj(p_tau))
    commits = {}
    for name, pl in polys.items():
        res = msm.msm(ptau_n, fr.from_mont(pl.coeffs))
        commits[name] = g1.decode_points(pmap(lambda c: c[:, None], res))[0]
    host_g2 = host_mul_g2(curve, tau)
    zk = PlonkZKey(
        curve=curve, n_vars=n, n_public=2, domain_size=n, power=log_n, n_additions=0,
        n_constraints=n, k1=k1, k2=k2, qm_c=commits["qm"], ql_c=commits["ql"],
        qr_c=commits["qr"], qo_c=commits["qo"], qc_c=commits["qc"], s1_c=commits["s1"],
        s2_c=commits["s2"], s3_c=commits["s3"], x_2=host_g2,
        add_id1=np.zeros(0, np.int64), add_id2=np.zeros(0, np.int64),
        add_f1=fr.zeros((0,)), add_f2=fr.zeros((0,)), map_a=maps[0], map_b=maps[1],
        map_c=maps[2], lagrange=[poly(e) for e in lag], p_tau=p_tau, **polys)
    vk = {"curve": curve, "n_public": 2, "power": log_n, "k1": k1, "k2": k2,
          "x_2": host_g2, **{k: commits[k] for k in ("qm", "ql", "qr", "qo", "qc", "s1",
                                                      "s2", "s3")}}
    # the witness: a^(k+1) for k <= n_mul as prefix products
    a = 3
    pw = fr.cumprod(fr.encode([a]).expand(fr.L, n_mul + 1).contiguous())
    y = int(fr.decode(pw[:, n_mul:])[0])
    return zk, vk, [y, a], pw[:, 1:n_mul].contiguous()


def phase_plonk_full(curve, device, log_n: int) -> dict:
    """3-party co-PLONK on plonk_key's chain of 2^log_n gates: REP3 cold and
    warm, then Shamir (t = 1); verify_plonk accepts each and refuses a
    changed public input.  Each transform is its ntt_columns launches and
    nothing else (three at 2^22); K1, K3, K4 and K5 launched.  Before the
    key, untimed: a 2^22 transform each way and one K1 launch at round 3's
    widest product, held to their plain versions.  Returns the launch counts
    of the cold REP3 and the Shamir proof."""
    from cocircom_tpu_torch.mpc.rep3 import share_field_vec
    from cocircom_tpu_torch.mpc.shamir import share_field_vec_shamir
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.field import get_field, mont_mul_plain
    from cocircom_tpu_torch.ops.ntt import ntt_engine
    from cocircom_tpu_torch.snark.groth16 import SharedWitness
    from cocircom_tpu_torch.snark.plonk_verify import verify_plonk

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    makers = plonk_makers(curve, device)

    # one transform of the extended domain each way: its ntt_columns launches
    # only (no mont_mul: the four-step factor is inside the first launch),
    # once the engine's tables for the size are built, equal to the plain
    # version of its levels; then intt(ntt(x)) = x
    t0 = time.perf_counter()
    eng = ntt_engine(fr, curve.fr)
    gen = torch.Generator(device=device).manual_seed(4646)
    x = rand_field(fr, (4 << log_n,), gen)
    eng.intt(eng.ntt(x))
    want = {"ntt_columns": columns_launches(log_n + 2)}
    y = {}
    for inverse in (False, True):
        kernels.reset_launch_counts()
        y[inverse] = (eng.intt if inverse else eng.ntt)(x)
        c = {k: v for k, v in kernels.launch_counts().items() if v}
        check(c == want, f"plonk_full: a 2^{log_n + 2} transform launched {c}, not {want}")
        check(torch.equal(y[inverse], plain_transform(eng, x, inverse)),
              f"plonk_full: a 2^{log_n + 2} {'inverse ' if inverse else ''}transform "
              "disagrees with the plain version of its levels")
    check(torch.equal(eng.intt(y[False]), x), f"plonk_full: intt(ntt(x)) != x at 2^{log_n + 2}")
    del x, y
    # K1 at round 3's widest product (Shamir: 32 vectors of 4n in one
    # mont_mul): one launch, equal to the plain version a piece at a time
    wide = 32 << (log_n + 2)
    piece = min(wide, 1 << 24)
    a, b = (torch.cat([rand_field(fr, (piece,), gen) for _ in range(wide // piece)], dim=1)
            for _ in range(2))
    kernels.reset_launch_counts()
    got = fr.mont_mul(a, b)
    c = {k: v for k, v in kernels.launch_counts().items() if v}
    check(c == {"mont_mul": 1}, f"plonk_full: a ({fr.L}, {wide}) product launched {c}")
    step = 1 << 20
    check(all(torch.equal(got[:, i:i + step], mont_mul_plain(fr, a[:, i:i + step],
                                                             b[:, i:i + step]))
              for i in range(0, wide, step)),
          f"plonk_full: mont_mul disagrees with mont_mul_plain at ({fr.L}, {wide})")
    del a, b, got
    precheck_s = time.perf_counter() - t0

    total = {k: 0 for k in kernels.COUNT_KEYS}
    proofs_out = []
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zk, vk, publics, aux = plonk_key(curve, log_n, device, seed=6000 + log_n)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pub = [1] + publics
    for proto, temps in (("rep3", ("cold", "warm")), ("shamir", ("cold",))):
        if proto == "rep3":
            shares = [SharedWitness(pub, s) for s in share_field_vec(fr, aux, seed=61)]
        else:
            shares = [SharedWitness(pub, s)
                      for s in share_field_vec_shamir(fr, aux, 1, 3, seed=62, device=device)]
        for temp in temps:
            torch.cuda.empty_cache()   # the proof before may have left the pool fragmented
            torch.cuda.reset_peak_memory_stats()
            with transform_sizes() as sizes:
                kernels.reset_launch_counts()
                proofs, wall, spans = plonk_prove(proto, makers[proto], zk, shares, traced=True)
                c = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            check(proofs[0] == proofs[1] == proofs[2], f"plonk_full: {proto} proofs differ")
            t0 = time.perf_counter()
            check(verify_plonk(vk, proofs[0], publics),
                  f"plonk_full: verify_plonk refused the {proto} proof")
            verify_s = time.perf_counter() - t0
            if temp == "cold":
                check(not verify_plonk(vk, proofs[0], [publics[0], publics[1] + 1]),
                      f"plonk_full: verify_plonk accepted a changed public input ({proto})")
                total = {k: total[k] + c[k] for k in total}
            logs = [s.bit_length() - 1 for s in sizes]
            expect = sum(columns_launches(m) for m in logs)
            check(c["ntt_columns"] == expect and c["ntt_butterfly"] == 0
                  and logs.count(log_n + 2) > 0,
                  f"plonk_full: {len(sizes)} transforms took {c['ntt_columns']} ntt_columns and "
                  f"{c['ntt_butterfly']} ntt_butterfly launches, not {expect} and 0")
            for k in ("mont_mul", "ntt_columns", "ec_add", "ec_madd"):
                check(c[k] > 0, f"plonk_full: {k} was never launched in the {proto} proof")
            proofs_out.append({
                "protocol": proto, "run": temp, "prove_s": round(wall, 3),
                "verify_s": round(verify_s, 2), "spans_party0": spans,
                "peak_device_bytes": int(peak),
                "transforms": {f"2^{m}": logs.count(m) for m in sorted(set(logs))},
                "launches": {k: v for k, v in c.items() if v}})
    emit({"phase": "plonk_full", "curve": curve.name, "log_n": log_n,
          "precheck_s": round(precheck_s, 2), "key_build_s": round(build_s, 2),
          "transform_2^%d_ntt_columns" % (log_n + 2): want["ntt_columns"],
          "proofs": proofs_out, "verified": True, "tamper_rejected": True})
    return total


# ---------------------------------------------------- phases: vm_small, vm_full

# the inline circom sources of tests/test_torch_vm.py (the circuits of the
# JAX package's tests/test_vm.py and tests/test_rep3_binary.py, and one each
# for bit ops, a binary-resident or/xor chain, sqrt, pow with guarded
# division and cmux, the chain)
VM_SOURCES = {
    "acc": """
    pragma circom 2.0.0;
    template Acc(N) {
        signal input in[N];
        signal output out;
        var acc = 0;
        for (var i = 0; i < N; i++) {
            if (i % 2 == 0) { acc += in[i] * in[i]; } else { acc += 2 * in[i]; }
        }
        out <== acc;
    }
    component main = Acc(5);
    """,
    "fib": """
    pragma circom 2.0.0;
    function fib(n) {
        var a = 0; var b = 1;
        for (var i = 0; i < n; i++) { var t = a + b; a = b; b = t; }
        return a;
    }
    template T() {
        signal input x;
        signal output out;
        signal output cmp;
        out <== x * fib(10);
        cmp <-- x > 5 ? 1 : 0;
    }
    component main = T();
    """,
    "cmp": """
    pragma circom 2.0.0;
    template Cmp() {
        signal input a;
        signal input b;
        signal output lt; signal output ge; signal output eq; signal output gt;
        lt <-- a < b;
        ge <-- a >= b;
        eq <-- a == b;
        gt <-- a > b;
    }
    component main = Cmp();
    """,
    "bits": """
    pragma circom 2.0.0;
    template Bits() {
        signal input a;
        signal input b;
        signal output bits[8];
        signal output x;
        signal output sh;
        for (var i = 0; i < 8; i++) { bits[i] <-- (a >> i) & 1; }
        x <-- (a & b) + (a | b) + (a ^ b);
        sh <-- (a << 3) + (b >> 2);
    }
    component main = Bits();
    """,
    "bitchain": """
    pragma circom 2.0.0;
    template BitChain() {
        signal input a;
        signal input b;
        signal output x;
        x <-- ((a & b) ^ (a | b)) ^ 5;
    }
    component main = BitChain();
    """,
    "sqrt": """
    pragma circom 2.0.0;
    function sqrt(n) { return n; }
    template Sqrt() {
        signal input a[3];
        signal output r[3];
        for (var i = 0; i < 3; i++) { r[i] <-- sqrt(a[i]); }
    }
    component main = Sqrt();
    """,
    "arith": """
    pragma circom 2.0.0;
    template Arith() {
        signal input a;
        signal input b;
        signal input c;
        signal output p5;
        signal output q;
        signal output g;
        signal output h;
        p5 <-- a ** 5;
        q <-- a / b;
        g <-- c ? a * b : b - a;
        var t = 1;
        if (c) { t = a / b; }
        h <-- t;
    }
    component main = Arith();
    """,
    "chain": """
    pragma circom 2.0.0;
    template Chain(N) {
        signal input a;
        signal output y;
        signal x[N];
        x[0] <== a;
        for (var i = 1; i < N; i++) { x[i] <== x[i-1] * a; }
        y <== x[N-1] * a;
    }
    component main {public [a]} = Chain(%d);
    """,
}
VM_SQRT_ROOT = 0x1234567890ABCDEF1234567890ABCDEF
VM_SHAMIR = ("acc", "arith", "chain")  # the tapes that need no binary domain

# vm_full: N cells, each a 254-bit decomposition, a signed comparison, an
# equality, a binary-resident bit chain, a product, a fifth power and a
# guarded division
VM_FULL_N = 256  # cells: cut from 1,024 so the whole script fits its time limit
VM_FULL_SRC = """
pragma circom 2.0.0;
template Num2Bits(n) {
    signal input in;
    signal output out[n];
    var lc1 = 0;
    var e2 = 1;
    for (var i = 0; i < n; i++) {
        out[i] <-- (in >> i) & 1;
        out[i] * (out[i] - 1) === 0;
        lc1 += out[i] * e2;
        e2 = e2 + e2;
    }
    lc1 === in;
}
template Cells(N) {
    signal input a[N];
    signal input b[N];
    signal output lt[N];
    signal output eq[N];
    signal output bx[N];
    signal output prod[N];
    signal output p5[N];
    signal output q[N];
    component bits[N];
    for (var i = 0; i < N; i++) {
        bits[i] = Num2Bits(254);
        bits[i].in <== a[i];
        lt[i] <-- a[i] < b[i];
        eq[i] <-- a[i] == b[i];
        bx[i] <-- (a[i] & b[i]) ^ (a[i] | b[i]);
        prod[i] <== a[i] * b[i];
        p5[i] <-- a[i] ** 5;
        q[i] <-- a[i] / b[i];
    }
}
component main = Cells(%d);
"""


def vm_inputs(p: int) -> dict:
    """The input cases of each small source: the cmp and arith cases take a
    secret zero divisor and p - 1 (which circom reads as -1); sqrt's are
    squares; (p - 1) | wide >= p, where a bit op's result must be reduced."""
    wide = (1 << (p.bit_length() - 1)) + 12345
    return {
        "acc": [{"in": [1, 2, 3, 4, 5]}],
        "fib": [{"x": 7}, {"x": 3}],
        "cmp": [{"a": 3, "b": 5}, {"a": p - 1, "b": 1}, {"a": 7, "b": 7}, {"a": 0, "b": p - 2}],
        "bits": [{"a": 0xB7, "b": 77}, {"a": p - 1, "b": wide}],
        "bitchain": [{"a": 0xB7, "b": 77}, {"a": p - 1, "b": wide}],
        "sqrt": [{"a": [49, 4, VM_SQRT_ROOT * VM_SQRT_ROOT % p]}],
        "arith": [{"a": 10, "b": 0, "c": 1}, {"a": p - 1, "b": 3, "c": 0}],
        "chain": [{"a": 3}],
    }


def counting_net(net):
    """A party's network that counts its messages to the next party: one a
    REP3 round."""
    from cocircom_tpu_torch.mpc.net import Network

    class Counted(Network):
        def __init__(self, inner):
            self.id, self.n_parties, self._inner, self.rounds = inner.id, inner.n_parties, inner, 0

        def send(self, to, obj):
            self.rounds += to == self.next_id
            self._inner.send(to, obj)

        def recv(self, frm):
            return self._inner.recv(frm)

        def stats(self):
            return self._inner.stats()

    return Counted(net)


def vm_flat(circuit, inputs: dict, p: int) -> list:
    vals = []
    for name in circuit.input_slots:
        v = inputs[name]
        vals.extend(v if isinstance(v, list) else [v])
    return [x % p for x in vals]


def vm_run_shared(phase, curve, circuit, cases, device, shamir=False) -> dict:
    """Every input case of one tape through run_shared on the card, all three
    parties, REP3 (or Shamir, t = 1): the opened witnesses of the parties
    equal each other and run_host at every slot; under REP3 party i's b is
    party i-1's a at every slot.  Returns party 0's rounds and bytes."""
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver, share_field_vec
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.mpc.shamir import ShamirDriver, share_field_vec_shamir
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.vm.mpc_vm import WitnessExtension

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    host = WitnessExtension(PlainDriver(curve, device=device), circuit)
    shares = []
    for j, inputs in enumerate(cases):
        vec = fr.encode(vm_flat(circuit, inputs, fr.p))
        shares.append(share_field_vec_shamir(fr, vec, 1, 3, seed=j, device=device) if shamir
                      else share_field_vec(fr, vec, seed=j))

    def party(i, net):
        net = counting_net(net)
        d = ShamirDriver(curve, net, 1, device=device) if shamir else Rep3Driver(curve, net, device)
        vm = WitnessExtension(d, circuit)
        out = []
        for sh in shares:
            w = vm.run_shared(sh[i], vm.all_input_slots())
            out.append((w, [int(v) for v in fr.decode(d.open_many(w))]))
        return out, net.rounds, net.stats()

    res = run_parties(party, 3)
    for j, inputs in enumerate(cases):
        want = host.run_host(inputs)
        for i in range(3):
            w, opened = res[i][0][j]
            check(opened == want, f"{phase}: party {i}'s opened witness differs from run_host "
                                  f"({inputs})")
            if not shamir:
                prev = res[(i - 1) % 3][0][j][0]
                check(torch.equal(w.b, prev.a), f"{phase}: the REP3 sharing is not replicated")
    return {"rounds": res[0][1], "sent_bytes": res[0][2][0]}


def vm_run_shared_input(curve, circuit, sis, device):
    """run_shared_input under REP3 on the card, three parties: (shared
    witnesses, wall seconds, party 0's rounds and bytes sent)."""
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.vm.mpc_vm import WitnessExtension

    def party(i, net):
        net = counting_net(net)
        sw = WitnessExtension(Rep3Driver(curve, net, device), circuit).run_shared_input(sis[i])
        return sw, net.rounds, net.stats()[0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_parties(party, 3)
    torch.cuda.synchronize()
    return [r[0] for r in res], time.perf_counter() - t0, res[0][1], res[0][2]


def vm_open(phase, curve, sws, device, want: list) -> None:
    """Open the shared witnesses (three parties): equal on every party,
    replicated, and [publics | opened] equal to run_host at every slot."""
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.ops.field import get_field

    opened = run_parties(lambda i, net: Rep3Driver(curve, net, device).open_many(sws[i].witness), 3)
    for i in range(3):
        check(torch.equal(opened[i], opened[0]), f"{phase}: the parties opened different witnesses")
        check(torch.equal(sws[i].witness.b, sws[(i - 1) % 3].witness.a),
              f"{phase}: the REP3 sharing is not replicated")
        check(sws[i].public_inputs == sws[0].public_inputs, f"{phase}: the publics differ")
    f = get_field(curve.fr.p, curve.name + ".fr", device)
    got = [int(v) for v in sws[0].public_inputs] + [int(v) for v in f.decode(opened[0])]
    check(got == want, f"{phase}: the opened witness differs from run_host at "
                       f"{sum(a != b for a, b in zip(got, want))} of {len(want)} slots")


def phase_vm_small(device) -> dict:
    """The witness extension on the card: every small tape under REP3, the
    arithmetic ones under Shamir, the comparisons over BLS12-381, then the
    pipeline: Chain(300) split with `a` public, run_shared_input, a REP3
    co-Groth16 proof of the shared witness, verified.  Returns the launch
    counts of the VM runs and of the proof."""
    from cocircom_tpu_torch.fields.params import BLS12_381
    from cocircom_tpu_torch.fields.params import BN254 as curve
    from cocircom_tpu_torch.io.r1cs import multiplier_chain
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.snark.groth16 import CoGroth16
    from cocircom_tpu_torch.snark.shared import split_input_rep3
    from cocircom_tpu_torch.vm.compiler import compile_circom
    from cocircom_tpu_torch.vm.mpc_vm import WitnessExtension

    p = curve.fr.p
    cases = vm_inputs(p)
    t0 = time.perf_counter()
    compiled = {n: compile_circom(src % 5 if n == "chain" else src, curve)
                for n, src in VM_SOURCES.items()}
    bls_cmp = compile_circom(VM_SOURCES["cmp"], BLS12_381)
    chain = compile_circom(VM_SOURCES["chain"] % SMALL_MULS, curve)
    compile_s = time.perf_counter() - t0
    zkey, vk, _, publics, _ = small_inputs(curve, device, SMALL_MULS, b"chip_smoke_vm")
    _, chain_vals = multiplier_chain(curve, SMALL_MULS, 3)
    check(WitnessExtension(PlainDriver(curve, device=device), chain).run_host({"a": 3})
          == chain_vals, "vm_small: Chain(300)'s host witness is not multiplier_chain's")
    sis = split_input_rep3(curve, {"a": 3}, chain.public_names, seed=11, device=device)

    stats = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for name, circuit in compiled.items():
        stats[name] = vm_run_shared("vm_small", curve, circuit, cases[name], device)
    for name in VM_SHAMIR:
        stats[name + "_shamir"] = vm_run_shared("vm_small (Shamir)", curve, compiled[name],
                                                cases[name], device, shamir=True)
    q = BLS12_381.fr.p
    stats["cmp_bls12_381"] = vm_run_shared(
        "vm_small (BLS12-381)", BLS12_381, bls_cmp,
        [{"a": a, "b": b} for a, b in ((3, 5), (q - 1, 1), (7, 7), (0, q - 2))], device)
    ops_s = time.perf_counter() - t0
    sws, vm_wall, rounds, sent = vm_run_shared_input(curve, chain, sis, device)
    counts_vm = kernels.launch_counts()
    check(counts_vm["mont_mul"] > 0 and counts_vm["mont_mul_l12"] == 0,
          "vm_small: the VM did not launch the 8-limb mont_mul")
    check(sws[0].public_inputs == [1, pow(3, SMALL_MULS + 1, p), 3],
          f"vm_small: the chain's publics are {sws[0].public_inputs[:3]}")
    vm_open("vm_small", curve, sws, device, chain_vals)
    kernels.reset_launch_counts()
    proofs, prove_s, _ = run_proof(lambda net, tr: CoGroth16(Rep3Driver(curve, net, device), tr),
                                   zkey, sws, traced=False)
    counts_prove = kernels.launch_counts()
    check_small_proofs("vm_small", vk, proofs, publics)
    emit({"phase": "vm_small", "compile_s": round(compile_s, 3), "tapes_s": round(ops_s, 3),
          "tapes": stats,
          "chain": {"n": SMALL_MULS, "vm_s": round(vm_wall, 3), "rounds_party0": rounds,
                    "sent_bytes_party0": sent, "prove_s": round(prove_s, 3),
                    "verified": True, "tamper_rejected": True},
          "mont_mul_vm": counts_vm["mont_mul"],
          "launches_prove": {k: v for k, v in counts_prove.items() if v}})
    return {k: counts_vm[k] + counts_prove[k] for k in kernels.COUNT_KEYS}


def phase_vm_full(curve, device, n: int) -> dict:
    """The witness extension at a real size: VM_FULL_SRC with n cells
    (n x Num2Bits(254) and the rest), compiled on the host, inputs from a
    seed, REP3 on the card cold and warm, the whole witness opened and held
    to run_host.  Returns the launch counts of the cold run."""
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.snark.shared import split_input_rep3
    from cocircom_tpu_torch.vm.compiler import compile_circom
    from cocircom_tpu_torch.vm.mpc_vm import WitnessExtension

    p = curve.fr.p
    t0 = time.perf_counter()
    circuit = compile_circom(VM_FULL_SRC % n, curve)
    compile_s = time.perf_counter() - t0
    rng = np.random.default_rng(4646)
    a = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    b = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    b[0], b[1] = 0, a[1]  # a guarded division by zero, an equality
    inputs = {"a": a, "b": b}
    t0 = time.perf_counter()
    want = WitnessExtension(PlainDriver(curve, device=device), circuit).run_host(inputs)
    host_s = time.perf_counter() - t0
    sis = split_input_rep3(curve, inputs, circuit.public_names, seed=12, device=device)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sws, cold, rounds, sent = vm_run_shared_input(curve, circuit, sis, device)
    counts = kernels.launch_counts()
    vm_open("vm_full", curve, sws, device, want)
    del sws
    sws, warm, rounds_w, sent_w = vm_run_shared_input(curve, circuit, sis, device)
    peak = torch.cuda.max_memory_allocated()
    vm_open("vm_full (warm)", curve, sws, device, want)
    check(counts["mont_mul"] > 0, "vm_full: the VM did not launch mont_mul")
    check((rounds_w, sent_w) == (rounds, sent), "vm_full: the warm run took other rounds")
    emit({"phase": "vm_full", "cells": n, "ops": sum(len(lv) for lv in circuit.levels),
          "levels": len(circuit.levels), "witness": circuit.n_vars, "temps": circuit.n_temps,
          "compile_s": round(compile_s, 2), "host_s": round(host_s, 3),
          "wall_cold_s": round(cold, 3), "wall_warm_s": round(warm, 3),
          "rounds_party0": rounds, "sent_bytes_party0": sent, "mont_mul": counts["mont_mul"],
          "launches": {k: v for k, v in counts.items() if v},
          "peak_device_bytes": int(peak), "witness_equals_host": True})
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


# -------------------------------------------- phase: honk_profile (optional)

def phase_honk_profile(curve, device, log_n: int) -> None:
    """One honk_full proof (REP3, three party threads, 2^log_n rows) under
    torch.profiler (device activity only), after an unprofiled one: the
    share of the wall time in which the card ran a kernel, and the device
    time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from cocircom_tpu_torch.honk.builder import acir_to_format
    from cocircom_tpu_torch.mpc.rep3 import share_field_vec
    from cocircom_tpu_torch.ops.field import get_field

    (c, _abi, w, _), _ = honk_chain(noir_fixtures(), log_n)
    af = acir_to_format(c)
    f = get_field(curve.fr.p, curve.name + ".fr", device)
    shares = share_field_vec(f, f.encode(w), seed=67)
    honk_prove(curve, device, af, len(w), shares, "rep3", False, False)   # not profiled
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall, _, _ = honk_prove(curve, device, af, len(w), shares, "rep3", False, False)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, int(e.count), us / 1e3))
    check(rows, "honk_profile: the profiler recorded no device time")
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    emit({"phase": "honk_profile", "log_n": log_n, "prove_profiled_s": round(wall, 3),
          "device_busy_ms": round(busy_ms, 1),
          "device_busy_share": round(busy_ms / (wall * 1e3), 4),
          "device_kernel_launches": sum(r[1] for r in rows),
          "top_kernels": [{"name": k[:80], "count": cnt, "ms": round(ms, 1)}
                          for k, cnt, ms in rows[:20]]})


# --------------------------------------------------------------------- main

# ------------------------------------------------------------------ phase: cli

CLI_CHAIN_SRC = """
pragma circom 2.0.0;
template SplitChain(N) {
    signal input a;
    signal input b;
    signal input c;
    signal output y;
    signal x[N];
    x[0] <== b * c;
    for (var i = 1; i < N; i++) { x[i] <== x[i-1] * a; }
    y <== x[N-1] * a;
}
component main {public [a]} = SplitChain(%d);
"""


def cli_chain(curve, n_cons: int, a: int, b: int, c: int):
    """The R1CS of CLI_CHAIN_SRC % (n_cons - 1): prove_small's multiplier
    chain whose first link multiplies two private inputs b and c (one for
    each of two input providers), y = b c a^(n_cons - 1).  Wires, in circom's
    order: 0 = 1, 1 = y (public output), 2 = a (public input), 3 = b, 4 = c,
    5.. = x.  Returns (r1cs, witness values as ints)."""
    from cocircom_tpu_torch.io.r1cs import R1CS

    p = curve.fr.p
    n = n_cons - 1
    vals = [1, None, a % p, b % p, c % p]
    x = [vals[3] * vals[4] % p]
    for _ in range(1, n):
        x.append(x[-1] * vals[2] % p)
    vals[1] = x[-1] * vals[2] % p
    vals += x
    cons = [([(3, 1)], [(4, 1)], [(5, 1)])]
    cons += [([(4 + i, 1)], [(2, 1)], [(5 + i, 1)]) for i in range(1, n)]
    cons.append(([(4 + n, 1)], [(2, 1)], [(1, 1)]))
    r1cs = R1CS(curve=curve, n_wires=len(vals), n_pub_out=1, n_pub_in=1, n_prv_in=2,
                n_labels=len(vals), n_constraints=len(cons), constraints=cons,
                wire_mapping=list(range(len(vals))))
    return r1cs, vals


def write_r1cs(r1cs) -> bytes:
    """An R1CS in the iden3 .r1cs format that `read_r1cs` reads: header
    (section 1), constraints with standard-form coefficients (section 2),
    wire-to-label map (section 3).  Neither package writes .r1cs files."""
    import struct

    from cocircom_tpu_torch.io.binfile import write_binfile

    p = r1cs.curve.fr.p
    n8 = 4 * -(-p.bit_length() // 32)
    hdr = (struct.pack("<I", n8) + p.to_bytes(n8, "little")
           + struct.pack("<IIIIQI", r1cs.n_wires, r1cs.n_pub_out, r1cs.n_pub_in,
                         r1cs.n_prv_in, r1cs.n_labels, r1cs.n_constraints))
    cons = []
    for lcs in r1cs.constraints:
        for terms in lcs:
            cons.append(struct.pack("<I", len(terms)))
            for wire, coeff in terms:
                cons.append(struct.pack("<I", wire) + (coeff % p).to_bytes(n8, "little"))
    labels = r1cs.wire_mapping or list(range(r1cs.n_wires))
    return write_binfile("r1cs", 1, [(1, hdr), (2, b"".join(cons)),
                                     (3, struct.pack(f"<{len(labels)}Q", *labels))])


ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_FULL_FILES = ("full.zkey", "full.w0.shared", "full.w1.shared", "full.w2.shared")
# the spans of cli.cmd_generate_proof that the cli line reports
CLI_SPANS = {"startup (torch, CUDA context, kernels)": "startup_s", "read witness": "read_witness_s",
             "mesh (connect, PRF setup)": "mesh_s", "read zkey": "read_zkey_s",
             "generate-proof groth16": "prove_s"}
# the kernels each 2^20 party must report having launched
CLI_FULL_KERNELS = ("mont_mul", "ntt_columns", "ec_add", "ec_madd", "ec_add_g2", "ec_wave_add_g2")


def _mont_bytes(v: int, p: int, n8: int) -> bytes:
    return (v * pow(2, 8 * n8, p) % p).to_bytes(n8, "little")


def _points_bytes(coords) -> bytes:
    """(L, n) coordinate tensors -> the zkey's point-major Montgomery bytes."""
    return torch.stack(list(coords)).permute(2, 0, 1).contiguous().cpu().numpy().tobytes()


def write_groth16_zkey(zkey) -> bytes:
    """A Groth16 key held as tensors (prove_full's synthetic one) as snarkjs
    .zkey bytes that `read_groth16_zkey` reads back: the header and vk points
    in Montgomery form, the IC as (n_public + 1) copies of the generator (the
    synthetic key has none; the prover does not read it), the matrices with
    each coefficient as v R^2 and snarkjs' public-input rows (which the
    loader drops), the query arrays as they are in memory."""
    import struct

    from cocircom_tpu_torch.io.binfile import write_binfile
    from cocircom_tpu_torch.ops.field import get_field

    curve = zkey.curve
    q, r = curve.fq.p, curve.fr.p
    n8q, n8r = curve.fq.n8, curve.fr.n8

    def g1(pt):
        return bytes(2 * n8q) if pt is None else b"".join(_mont_bytes(v, q, n8q) for v in pt)

    def g2(pt):
        return bytes(4 * n8q) if pt is None else b"".join(
            _mont_bytes(v, q, n8q) for c in pt for v in c)

    hdr = b"".join([
        struct.pack("<I", n8q), q.to_bytes(n8q, "little"),
        struct.pack("<I", n8r), r.to_bytes(n8r, "little"),
        struct.pack("<III", zkey.n_vars, zkey.n_public, zkey.domain_size),
        g1(zkey.alpha_g1), g1(zkey.beta_g1), g2(zkey.beta_g2), g2(zkey.gamma_g2),
        g1(zkey.delta_g1), g2(zkey.delta_g2)])
    m = zkey.matrices
    fr = get_field(r, curve.name + ".fr", m.a_coeffs.device)
    rec = np.dtype([("matrix", "<u4"), ("constraint", "<u4"), ("signal", "<u4"),
                    ("value", f"V{n8r}")])
    parts = []
    for mid, rows, cols, coeffs in ((0, m.a_rows, m.a_cols, m.a_coeffs),
                                    (1, m.b_rows, m.b_cols, m.b_coeffs)):
        e = np.empty(rows.numel(), dtype=rec)
        e["matrix"] = mid
        e["constraint"] = rows.cpu().numpy()
        e["signal"] = cols.cpu().numpy()
        # Montgomery v R -> the file's v R^2 (one more factor R), LE limbs
        vr2 = fr.to_mont(coeffs).T.contiguous().cpu().numpy()
        e["value"] = vr2.view(f"V{n8r}")[:, 0]
        parts.append(e)
    pub = np.empty(zkey.n_public + 1, dtype=rec)
    pub["matrix"] = 0
    pub["constraint"] = m.num_constraints + np.arange(zkey.n_public + 1)
    pub["signal"] = np.arange(zkey.n_public + 1)
    pub["value"] = np.frombuffer(pow(2, 16 * n8r, r).to_bytes(n8r, "little"), f"V{n8r}")[0]
    entries = np.concatenate(parts + [pub])
    sections = [
        (1, struct.pack("<I", 1)),
        (2, hdr),
        (3, g1(curve.g1_gen) * (zkey.n_public + 1)),
        (4, struct.pack("<I", len(entries)) + entries.tobytes()),
        (5, _points_bytes((zkey.a_query.x, zkey.a_query.y))),
        (6, _points_bytes((zkey.b_g1_query.x, zkey.b_g1_query.y))),
        (7, _points_bytes((zkey.b_g2_query.x0, zkey.b_g2_query.x1, zkey.b_g2_query.y0,
                           zkey.b_g2_query.y1))),
        (8, _points_bytes((zkey.l_query.x, zkey.l_query.y))),
        (9, _points_bytes((zkey.h_query.x, zkey.h_query.y))),
    ]
    return write_binfile("zkey", 1, sections)


def zkey_differences(a, b) -> list:
    """The fields in which two Groth16 keys differ (the IC is not compared:
    the synthetic key has none)."""
    diff = [k for k in ("curve", "n_vars", "n_public", "domain_size", "pow", "alpha_g1",
                        "beta_g1", "beta_g2", "gamma_g2", "delta_g1", "delta_g2")
            if getattr(a, k) != getattr(b, k)]
    arrays = {"a_query": ("x", "y"), "b_g1_query": ("x", "y"), "l_query": ("x", "y"),
              "h_query": ("x", "y"), "b_g2_query": ("x0", "x1", "y0", "y1")}
    for k, coords in arrays.items():
        if not all(torch.equal(getattr(getattr(a, k), c), getattr(getattr(b, k), c))
                   for c in coords):
            diff.append(k)
    ma, mb = a.matrices, b.matrices
    if (ma.num_constraints, ma.num_instance) != (mb.num_constraints, mb.num_instance):
        diff.append("matrices")
    for k in ("a_rows", "a_cols", "a_coeffs", "b_rows", "b_cols", "b_coeffs"):
        if not torch.equal(getattr(ma, k), getattr(mb, k)):
            diff.append(k)
    return diff


_SPAN_ROW = re.compile(r"^ *(.+?) +(-?[\d.]+)ms +(\d+)B +(\d+)B$")


def parse_report(err: str):
    """A party's Tracer.report from its stderr: ({span: (seconds, sent,
    received)}, the proof's launch counts, peak device bytes, the set-up's
    launch counts, the party's waits {"recv_wait_s", "turn_wait_s"})."""
    spans, launches, peak, setup, waits = {}, None, None, None, None
    for line in err.splitlines():
        if line.startswith("waits "):
            waits = json.loads(line[len("waits "):])
        elif line.startswith("launches "):
            launches = json.loads(line[len("launches "):])
        elif line.startswith("launches_setup "):
            setup = json.loads(line[len("launches_setup "):])
        elif line.startswith("peak_device_bytes "):
            peak = int(line.split()[1])
        else:
            m = _SPAN_ROW.match(line)
            if m:
                spans[m.group(1)] = (float(m.group(2)) / 1e3, int(m.group(3)), int(m.group(4)))
    return spans, launches, peak, setup, waits


class CliRunner:
    """Runs `python -m cocircom_tpu_torch.cli --device cuda ...` processes
    (or those of another CLI module: the noir CLI for noir_cli) from the
    repository root.  A stage starts its
    processes together and waits for all of them; each one's stdout and
    stderr go to files under `work/logs`.  An unexpected exit code or a
    timeout prints the tail of every log of the stage and fails the script;
    no process outlives its stage."""

    def __init__(self, work: str, module: str = "cocircom_tpu_torch.cli"):
        self.work = work
        self.module = module
        self.logs = os.path.join(work, "logs")
        os.makedirs(self.logs, exist_ok=True)
        self.env = dict(os.environ, PYTHONUNBUFFERED="1", COCIRCOM_TRACE="1")
        self.seconds = {}

    def stage(self, name: str, argvs: list, expect=None, timeout: float = 300.0) -> list:
        """argvs: the cli arguments of each process; expect: each one's exit
        code (default 0).  Returns [(exit code, stdout, stderr)]."""
        expect = expect or [0] * len(argvs)
        procs = []
        t0 = time.perf_counter()
        try:
            for i, argv in enumerate(argvs):
                base = os.path.join(self.logs, f"{name}.{i}")
                out, err = open(base + ".out", "w"), open(base + ".err", "w")
                cmd = [sys.executable, "-m", self.module, "--device", "cuda", *argv]
                procs.append((base, out, err, subprocess.Popen(
                    cmd, cwd=ROOT, env=self.env, stdout=out, stderr=err,
                    stdin=subprocess.DEVNULL)))
            deadline = time.monotonic() + timeout
            for *_, proc in procs:
                try:
                    proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for _, out, err, _ in procs:
                out.close()
                err.close()
        self.seconds[name] = round(time.perf_counter() - t0, 2)
        results = []
        bad = []
        for (base, *_, proc), want in zip(procs, expect):
            out_text = open(base + ".out").read()
            err_text = open(base + ".err").read()
            results.append((proc.returncode, out_text, err_text))
            if proc.returncode != want:
                bad.append(base)
        if bad or len(procs) != len(argvs):
            for (base, *_, proc), (rc, out_text, err_text) in zip(procs, results):
                print(f"--- {os.path.basename(base)}: exit {rc}\n{out_text[-2000:]}"
                      f"\n{err_text[-4000:]}", file=sys.stderr)
            fail(f"cli: stage {name}: {[os.path.basename(b) for b in bad]} exited other than "
                 f"{expect} (-9: killed at the {timeout:.0f} s limit)")
        return results


def cli_mesh_configs(work: str, name: str, ports: list, certs) -> list:
    """The three net-config files of one mesh; mutual TLS with `certs`
    [(key, cert)] (None: plain TCP)."""
    paths = []
    for i in range(3):
        cfg = {"my_id": i, "parties": [{"id": j, "host": "127.0.0.1", "port": ports[j]}
                                       for j in range(3)]}
        if certs:
            cfg["key_path"] = certs[i][0]
            for j, party in enumerate(cfg["parties"]):
                party["cert_path"] = certs[j][1]
        path = os.path.join(work, f"net.{name}.{i}.json")
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        paths.append(path)
    return paths


def cli_prepare_full(curve, device, inputs, work: str) -> dict:
    """prove_full's synthetic key written as a .zkey file, read back by the
    port's loader and held equal to the key in memory, and the three REP3
    witness shares written as .shared files (shared_witness_from_split)."""
    from cocircom_tpu_torch.io.shares_io import shared_witness_from_split
    from cocircom_tpu_torch.io.zkey import read_groth16_zkey

    zkey, _, _, shares, _ = inputs
    t0 = time.perf_counter()
    data = write_groth16_zkey(zkey)
    with open(os.path.join(work, CLI_FULL_FILES[0]), "wb") as fh:
        fh.write(data)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = read_groth16_zkey(data, device=device)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    diff = zkey_differences(zkey, back)
    check(not diff, f"cli: the .zkey read back differs from the key in memory in {diff}")
    del back, data
    for i, sw in enumerate(shares):
        with open(os.path.join(work, CLI_FULL_FILES[1 + i]), "wb") as fh:
            fh.write(shared_witness_from_split("rep3", curve, sw))
    return {"zkey_bytes": os.path.getsize(os.path.join(work, CLI_FULL_FILES[0])),
            "zkey_write_s": round(write_s, 2), "zkey_read_back_s": round(read_s, 2),
            "zkey_equal": True, "constraints": zkey.matrices.num_constraints,
            "domain_size": zkey.domain_size, "witness_publics": shares[0].public_inputs}


def tls_status():
    """None when gen-cert can run here, else why not."""
    try:
        import cryptography  # noqa: F401
    except ImportError as e:
        return f"unavailable: {e}"
    return None


def cli_small(curve, run: CliRunner, work: str, meshes: dict) -> dict:
    """The small pipelines through the CLI, each subcommand its own
    process(es): setup (groth16, plonk) from write_r1cs's file of
    cli_chain, split-input twice (b and c from two providers), merge, the
    REP3 witness extension (opened here and held to run_host), REP3, Shamir
    and PLONK proofs from its shares and a plain one from a plain .wtns;
    every proof accepted by verify and refused with a changed public input,
    the parties' proofs byte-equal."""
    from cocircom_tpu_torch.io.shares_io import shared_witness_to_split
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.mpc.rep3 import combine_field_shares
    from cocircom_tpu_torch.ops.field import get_field
    from cocircom_tpu_torch.vm.compiler import compile_circom
    from cocircom_tpu_torch.vm.mpc_vm import WitnessExtension

    w = lambda name: os.path.join(work, name)  # noqa: E731
    inputs = {"a": 3, "b": 5, "c": 7}
    r1cs, vals = cli_chain(curve, SMALL_MULS, **inputs)
    with open(w("chain.r1cs"), "wb") as fh:
        fh.write(write_r1cs(r1cs))
    src = CLI_CHAIN_SRC % (SMALL_MULS - 1)
    with open(w("chain.circom"), "w") as fh:
        fh.write(src)
    for name, d in (("input", inputs), ("p1", {"a": 3, "b": 5}), ("p2", {"a": 3, "c": 7})):
        with open(w(f"{name}.json"), "w") as fh:
            json.dump(d, fh)
    host = WitnessExtension(PlainDriver(curve, device="cuda"), compile_circom(src, curve))
    check(host.run_host(inputs) == vals, "cli: SplitChain's host witness is not cli_chain's")

    a = [["setup", "groth16", w("chain.r1cs"), w("g16.zkey"), "--vk", w("g16.vk.json"),
          "--seed", "chip_smoke_cli"],
         ["setup", "plonk", w("chain.r1cs"), w("plonk.zkey"), "--vk", w("plonk.vk.json"),
          "--seed", "chip_smoke_cli"],
         ["split-input", "--input", w("p1.json"), "--circuit", w("chain.circom"),
          "--out-dir", w("p1")],
         ["split-input", "--input", w("p2.json"), "--circuit", w("chain.circom"),
          "--out-dir", w("p2")],
         ["generate-witness", "--circuit", w("chain.circom"), "--input", w("input.json"),
          "--out", w("plain.wtns")]]
    run.stage("setup_split", a)
    b = [["merge-input-shares", w(f"p1/p1.json.{i}.shared"), w(f"p2/p2.json.{i}.shared"),
          "--out", w(f"merged.{i}.shared")] for i in range(3)]
    b.append(["split-witness", "--witness", w("plain.wtns"), "--r1cs", w("chain.r1cs"),
              "--protocol", "plain", "--out-dir", w("plain")])
    run.stage("merge", b)
    c = [["generate-witness", "--protocol", "rep3", "--circuit", w("chain.circom"),
          "--input", w(f"merged.{i}.shared"), "--net-config", meshes["witness"][i],
          "--out", w(f"sw.{i}.shared")] for i in range(3)]
    c.append(["generate-proof", "groth16", "--zkey", w("g16.zkey"), "--witness",
              w("plain/witness.wtns.0.shared"), "--out", w("plain.proof.json"),
              "--public-out", w("public.json")])
    res_c = run.stage("witness", c)

    # the three shared witnesses, opened here, equal run_host at every slot
    fr = get_field(curve.fr.p, curve.name + ".fr", "cuda")
    sws = []
    for i in range(3):
        with open(w(f"sw.{i}.shared"), "rb") as fh:
            sws.append(shared_witness_to_split(fh.read(), device="cuda"))
    check(all(s[0] == "rep3" and s[2].public_inputs == vals[:3] for s in sws),
          "cli: the shared witnesses' publics are not the chain's")
    opened = combine_field_shares(fr, [s[2].witness for s in sws])
    check([int(v) for v in fr.from_limbs(fr.from_mont(opened))] == vals[3:],
          "cli: the opened REP3 witness differs from run_host")
    del sws, opened

    with open(w("public.json")) as fh:
        publics = json.load(fh)
    check(publics == [str(v) for v in vals[1:3]], f"cli: public.json holds {publics}")
    with open(w("bad_public.json"), "w") as fh:
        json.dump([publics[0], str(int(publics[1]) + 1)], fh)

    def verify(system, proof, vk):
        return [["verify", system, "--proof", proof, "--vk", vk, "--public", w("public.json")],
                ["verify", system, "--proof", proof, "--vk", vk, "--public", w("bad_public.json")]]

    d = [["generate-proof", "groth16", "--zkey", w("g16.zkey"), "--witness", w(f"sw.{i}.shared"),
          "--net-config", meshes["groth16"][i], "--out", w(f"rep3.proof.{i}.json")]
         for i in range(3)]
    d += [["translate-witness", "--witness", w(f"sw.{i}.shared"), "--net-config",
           meshes["translate"][i], "--out", w(f"shamir.{i}.shared")] for i in range(3)]
    d += [["generate-proof", "plonk", "--zkey", w("plonk.zkey"), "--witness", w(f"sw.{i}.shared"),
           "--net-config", meshes["plonk"][i], "--out", w(f"plonk.proof.{i}.json")]
          for i in range(3)]
    d += verify("groth16", w("plain.proof.json"), w("g16.vk.json"))
    res_d = run.stage("prove", d, expect=[0] * 9 + [0, 1])
    e = [["generate-proof", "groth16", "--zkey", w("g16.zkey"), "--witness",
          w(f"shamir.{i}.shared"), "--net-config", meshes["shamir"][i], "--threshold", "1",
          "--out", w(f"shamir.proof.{i}.json")] for i in range(3)]
    e += verify("groth16", w("rep3.proof.0.json"), w("g16.vk.json"))
    e += verify("plonk", w("plonk.proof.0.json"), w("plonk.vk.json"))
    res_e = run.stage("shamir_verify", e, expect=[0] * 3 + [0, 1, 0, 1])
    res_f = run.stage("verify_shamir", verify("groth16", w("shamir.proof.0.json"),
                                              w("g16.vk.json")), expect=[0, 1])
    for rc, out, _ in res_d[9:] + res_e[3:] + res_f:
        check(("verification: OK" in out) == (rc == 0), f"cli: verify printed {out!r}")
    for name in ("rep3.proof", "shamir.proof", "plonk.proof"):
        files = []
        for i in range(3):
            with open(w(f"{name}.{i}.json"), "rb") as fh:
                files.append(fh.read())
        check(files[0] == files[1] == files[2], f"cli: the parties' {name} files differ")

    launches = {}
    for _, _, err in res_c[3:] + res_d[:3] + res_d[6:9] + res_e[:3]:
        for k, v in (parse_report(err)[1] or {}).items():
            launches[k] = launches.get(k, 0) + v
    return {"constraints": SMALL_MULS, "witness_equals_host": True,
            "verified": ["plain", "rep3", "shamir", "plonk_rep3"],
            "tamper_rejected": ["plain", "rep3", "shamir", "plonk_rep3"],
            "proofs_identical": True, "launches": launches}


def cli_full(curve, run: CliRunner, work: str, mesh: list) -> dict:
    """Three generate-proof groth16 processes at 2^20 over the mesh: proofs
    byte-equal and on their curves; each party's report holds the startup,
    zkey read and prove spans, bytes, peak device memory and launches, and
    shows every kernel of CLI_FULL_KERNELS launched."""
    from cocircom_tpu_torch.io.jsonio import parse_groth16_proof

    w = lambda name: os.path.join(work, name)  # noqa: E731
    t0 = time.perf_counter()
    res = run.stage("full", [["generate-proof", "groth16", "--zkey", w(CLI_FULL_FILES[0]),
                              "--witness", w(CLI_FULL_FILES[1 + i]), "--net-config", mesh[i],
                              "--out", w(f"full.proof.{i}.json")] for i in range(3)],
                    timeout=600)
    wall = time.perf_counter() - t0
    files = []
    for i in range(3):
        with open(w(f"full.proof.{i}.json"), "rb") as fh:
            files.append(fh.read())
    check(files[0] == files[1] == files[2], "cli: the 2^20 parties' proof files differ")
    check(on_curve(curve, parse_groth16_proof(files[0])), "cli: a 2^20 proof point is off its curve")
    parties, total = [], {}
    for i, (_, _, err) in enumerate(res):
        spans, launches, peak, setup, waits = parse_report(err)
        missing = [k for k in CLI_FULL_KERNELS if not (launches or {}).get(k)]
        check(not missing, f"cli: party {i}'s report shows no launch of {missing}")
        check(all(k in spans for k in CLI_SPANS), f"cli: party {i}'s report lacks a span: {spans}")
        prove = spans["generate-proof groth16"]
        parties.append({**{v: round(spans[k][0], 3) for k, v in CLI_SPANS.items()},
                        "spans": {k: round(v[0], 3) for k, v in spans.items()
                                  if k not in CLI_SPANS},
                        "sent_bytes": prove[1], "recv_bytes": prove[2],
                        "peak_device_bytes": peak, "launches": launches,
                        "launches_setup": setup, "waits": waits})
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return {"parties": parties, "wall_spawn_to_last_exit_s": round(wall, 3),
            "proofs_identical": True, "on_curve": True, "launches": total}


def msm_setup_launches(curve, device, sizes) -> dict:
    """Launch counts of the G1 MSM engine's one-time state in a new process:
    the bucket-init point D and one correction E*D for each window width
    that MSMs of `sizes` points take.  Three party threads of one process
    share it (msm_engine is cached per process); three party processes
    each build their own."""
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.curve import g1_ops
    from cocircom_tpu_torch.ops.msm import MSM

    bits = curve.fr.p.bit_length()
    eng = MSM(g1_ops(curve, device), scalar_bits=bits)
    widths = sorted({eng._window_c(min(n, 1 << eng.CHUNK_LOG)) for n in sizes})
    kernels.reset_launch_counts()
    eng._init_affine()
    for c in widths:
        eng._madd_correction(bits, c)
    torch.cuda.synchronize()
    return {"window_widths": widths,
            "launches": {k: v for k, v in kernels.launch_counts().items() if v}}


def phase_cli(curve, device, work: str, prepared: dict, warm, smi_line: str) -> dict:
    """The port's CLI as separate party processes on the card (see the
    module docstring).  `warm` is this run's in-process warm prove_full:
    (wall seconds, launch counts or None).  Returns the summed launch counts
    of every generate-proof process."""
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "cli_memory", "free_bytes": free, "total_bytes": total,
          "allocated_bytes": torch.cuda.memory_allocated()})
    run = CliRunner(work)
    tls = tls_status()
    certs = None
    cert_argv = [["gen-cert", "--key-out", os.path.join(work, f"key{i}.pem"),
                  "--cert-out", os.path.join(work, f"cert{i}.pem")] for i in range(3)]
    if tls is None:
        run.stage("gen_cert", cert_argv)
        certs = [(os.path.join(work, f"key{i}.pem"), os.path.join(work, f"cert{i}.pem"))
                 for i in range(3)]
    else:
        res = run.stage("gen_cert", cert_argv, expect=[1] * 3)
        check(all("cryptography" in err for _, _, err in res),
              "cli: gen-cert failed without naming the missing package")
    ports = free_ports(3 * 6)
    meshes = {name: cli_mesh_configs(work, name, ports[3 * k: 3 * k + 3], certs)
              for k, name in enumerate(("witness", "groth16", "translate", "plonk", "shamir",
                                        "full"))}
    small = cli_small(curve, run, work, meshes)
    full = cli_full(curve, run, work, meshes["full"])
    # the K4 launches of the three processes against the warm in-process
    # proof: each process builds its own MSM engine state
    setup = msm_setup_launches(curve, device, (len(prepared["witness_publics"]) - 1,
                                               prepared["domain_size"]))
    warm_s, warm_counts = warm
    compare = None
    if warm_counts is not None:
        compare = {"ec_add_cli": full["launches"].get("ec_add", 0),
                   "ec_add_warm_prove_full": warm_counts["ec_add"],
                   "ec_add_msm_setup_x3": 3 * setup["launches"].get("ec_add", 0)}
    emit({"phase": "cli", "tls": "mutual, pinned certificates" if tls is None else tls,
          "small": small, "full": {**prepared, **full}, "stage_seconds": run.seconds,
          "in_process_prove_full_warm_s": warm_s,
          "in_process_prove_full_warm_launches":
              None if warm_counts is None else {k: v for k, v in warm_counts.items() if v},
          "msm_setup_per_process": setup, "ec_add_cli_vs_warm": compare, "device": smi_line})
    return {k: small["launches"].get(k, 0) + full["launches"].get(k, 0)
            for k in set(small["launches"]) | set(full["launches"])}


# ------------------------------------------------------------ phases: co-noir

# n = 2^20 rows for honk_full: the Poseidon-style chain has 16 opcodes a
# round, each one row, and 19 rows besides (the zero row, two public
# inputs, 16 rows that make every selector non-zero): 65,534 rounds are
# 1,048,563 rows, 13 of padding.
HONK_LOG = 20
NOIR_CLI = "cocircom_tpu_torch.noir.cli"
NOIR_CLI_KERNELS = ("mont_mul", "ec_add")


def honk_rounds(log_n: int) -> int:
    return ((1 << log_n) - 19) // 16


_HONK_CHAINS: dict = {}


def honk_chain(u, log_n: int):
    """honk_full's circuit (circuit, abi, witness, inputs) and the seconds
    it took to make: made once a process, noir_cli writes the same one."""
    if log_n not in _HONK_CHAINS:
        t0 = time.perf_counter()
        chain = u.poseidon_chain(honk_rounds(log_n), 6464)
        _HONK_CHAINS[log_n] = (chain, time.perf_counter() - t0)
    return _HONK_CHAINS[log_n]


def noir_fixtures():
    """tests/torch_port_util.py: the ACIR circuits built in code and the
    ACIR writer, which neither package has (the port reads ACIR but writes
    none).  The import keeps this process's torch thread count."""
    threads = torch.get_num_threads()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import torch_port_util
    finally:
        sys.path.remove(os.path.join(ROOT, "tests"))
        torch.set_num_threads(threads)
    return torch_port_util


def honk_prove(curve, device, af, nvars: int, shares, protocol: str, provider: bool,
               traced: bool):
    """Three party threads, party i building its own UltraCircuitBuilder
    over the ACIR format `af` (provider mode, MpcBuilderValues, when
    `provider`) and proving with CoUltraHonk from shares[i] under
    `protocol` (rep3 or shamir).  Returns (proofs, wall seconds, party 0's
    span seconds and bytes, party 0's rounds to the next party)."""
    from cocircom_tpu_torch.honk.builder import UltraCircuitBuilder
    from cocircom_tpu_torch.honk.co_builder import MpcBuilderValues
    from cocircom_tpu_torch.honk.co_prover import CoUltraHonk
    from cocircom_tpu_torch.honk.crs import TestCrs
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.mpc.shamir import ShamirDriver
    from cocircom_tpu_torch.utils.trace import Tracer

    rows, rounds = [], []

    def party(i, net):
        cnet = counting_net(net)
        d = (Rep3Driver(curve, cnet, device=device) if protocol == "rep3"
             else ShamirDriver(curve, cnet, 1, device=device))
        tr = Tracer(enabled=traced and i == 0, net=cnet, sync=torch.cuda.synchronize)
        with tr.span("builder"):
            b = UltraCircuitBuilder(af, [0] * nvars,
                                    mpc=MpcBuilderValues(d, shares[i]) if provider else None)
        proof = CoUltraHonk(d, TestCrs(), tracer=tr).prove(b, shares[i])
        if i == 0:
            rows.extend(tr.rows)
            rounds.append(cnet.rounds)
        return proof

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proofs = run_parties(party, 3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = {name: {"s": round(dt, 3), "sent_bytes": sent, "recv_bytes": recvd}
             for _, name, dt, sent, recvd in rows}
    return proofs, wall, spans, rounds[0]


def provider_plain_proof(curve, device, c, w: list):
    """The port's plain UltraHonk prover over a circuit's provider-mode
    structure (the oblivious ROM/RAM gates a co-prover proves): the builder
    runs with a plain driver, is finalized, every shared value is filled
    in on the host (the sorted RAM rows' access types, which the co-prover
    adds into w_4, as memory read records), then the keys are made.
    Returns (proof, vk)."""
    from cocircom_tpu_torch.honk import prover
    from cocircom_tpu_torch.honk.builder import UltraCircuitBuilder, acir_to_format
    from cocircom_tpu_torch.honk.co_builder import MpcBuilderValues
    from cocircom_tpu_torch.honk.crs import TestCrs
    from cocircom_tpu_torch.honk.proving_key import create_keys
    from cocircom_tpu_torch.mpc.driver import PlainDriver

    p = curve.fr.p
    dp = PlainDriver(curve, device=device)
    m = MpcBuilderValues(dp, dp.promote_public(dp.fr.encode(w)))
    b = UltraCircuitBuilder(acir_to_format(c), [0] * len(w), mpc=m)
    b.add_gates_to_ensure_all_polys_are_non_zero()
    b.finalize_circuit()
    for i, v in enumerate(w):
        b.variables[i] = v % p
    for i, h in m.extra.items():
        b.variables[i] = int(dp.fr.decode(h)[0])
    pk, vk = create_keys(b, TestCrs())
    for r, h in zip(pk.memory_mixed_records, m.mixed_access):
        pk.witness[3][r] = (pk.witness[3][r] + int(dp.fr.decode(h)[0])) % p
    pk.memory_read_records = list(pk.memory_read_records) + list(pk.memory_mixed_records)
    return prover.prove(pk), vk


def honk_verify(phase: str, proof, vk) -> None:
    """The host verifier accepts the proof and refuses it with its first
    public input changed."""
    from cocircom_tpu_torch.honk import verifier
    from cocircom_tpu_torch.honk.builder import P

    check(verifier.verify(proof, vk), f"{phase}: the verifier refused the proof")
    changed = list(proof)
    changed[3] = (changed[3] + 1) % P
    check(not verifier.verify(changed, vk), f"{phase}: a changed public input was accepted")


def add_counts(*runs) -> dict:
    return {k: sum(r.get(k, 0) for r in runs) for k in set().union(*runs)}


def phase_honk_small(curve, device) -> dict:
    """co-noir at a small size on the card: the co-ACVM under REP3 on a
    ROM/RAM circuit (a ROM block read at a shared index, a RAM block written
    and read at shared indices: Rep3Lut), opened and held to the plain
    solver; the REP3 co-proof of that circuit from the co-ACVM's witness
    shares (provider mode: LUT reads and writes, oblivious sorts in the
    builder) and the REP3 and Shamir co-proofs of the 16-gate squaring
    chain, each byte-equal to the port's plain prover, verified, a changed
    public input refused; a FileCrs commit of 64 coefficients through
    driver_msm equal to TestCrs.commit.  K1 and K4 must be launched by the
    proofs, K5 by the driver_msm commit.  Returns the launch counts of the
    co-ACVM, the proofs and the commit."""
    from cocircom_tpu_torch.honk import crs as honk_crs
    from cocircom_tpu_torch.honk import prover
    from cocircom_tpu_torch.honk.builder import UltraCircuitBuilder, acir_to_format
    from cocircom_tpu_torch.honk.proving_key import create_keys
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.mpc.rep3 import Rep3Driver, share_field_vec
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.mpc.shamir import share_field_vec_shamir
    from cocircom_tpu_torch.noir.rep3_driver import Rep3NoirDriver
    from cocircom_tpu_torch.noir.solver import AcvmSolver, PlainNoirDriver, Shared
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.field import get_field

    u = noir_fixtures()
    p = curve.fr.p
    f = get_field(p, curve.name + ".fr", device)
    c, _abi, w, inputs = u.memory_circuit(61)
    plain = AcvmSolver(PlainNoirDriver(p), c)
    plain.bind_inputs(inputs)
    out = plain.solve()
    want_w = [out.get(i, 0) for i in range(c.current_witness_index + 1)]
    check(want_w == w, "honk_small: the plain ACVM's witness differs from the fixture's")
    in_sh = share_field_vec(f, f.encode(inputs), seed=62)

    def acvm(i, net):
        d = Rep3NoirDriver(Rep3Driver(curve, net, device=device))
        s = AcvmSolver(d, c)
        s.bind_inputs([Shared(d.d.index_share(in_sh[i], k)) for k in range(len(inputs))])
        wmap = s.solve()
        handles = [v.v if isinstance(v, Shared) else d.promote(int(v))
                   for v in (wmap.get(k, 0) for k in range(len(w)))]
        return d.d.stack_shares(handles), d.open_many(handles)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_parties(acvm, 3)
    torch.cuda.synchronize()
    acvm_s = time.perf_counter() - t0
    acvm_counts = kernels.launch_counts()
    check(all(r[1] == want_w for r in res), "honk_small: the REP3 co-ACVM opened another witness")

    walls, rounds = {}, {}
    kernels.reset_launch_counts()
    mem, walls["rep3_rom_ram"], _, rounds["rep3_rom_ram"] = honk_prove(
        curve, device, acir_to_format(c), len(w), [r[0] for r in res], "rep3", True, False)
    c2, _abi2, w2, _ = u.squaring_chain(16, 63)
    af2 = acir_to_format(c2)
    ch3, walls["rep3_chain"], _, rounds["rep3_chain"] = honk_prove(
        curve, device, af2, len(w2), share_field_vec(f, f.encode(w2), seed=64), "rep3", False,
        False)
    chs, walls["shamir_chain"], _, rounds["shamir_chain"] = honk_prove(
        curve, device, af2, len(w2), share_field_vec_shamir(f, f.encode(w2), 1, 3, seed=65,
                                                            device=device),
        "shamir", False, False)
    proof_counts = kernels.launch_counts()
    for k in ("mont_mul", "ec_add"):
        check(proof_counts[k] > 0, f"honk_small: the co-proofs launched no {k}")

    want_mem, vk_mem = provider_plain_proof(curve, device, c, w)
    check(mem[0] == mem[1] == mem[2] == want_mem,
          "honk_small: the REP3 ROM/RAM co-proof differs from the plain prover's")
    honk_verify("honk_small (ROM/RAM)", mem[0], vk_mem)
    pk2, vk2 = create_keys(UltraCircuitBuilder(af2, w2), honk_crs.TestCrs())
    want_chain = prover.prove(pk2)
    for name, proofs in (("REP3", ch3), ("Shamir", chs)):
        check(proofs[0] == proofs[1] == proofs[2] == want_chain,
              f"honk_small: the {name} chain co-proof differs from the plain prover's")
        honk_verify(f"honk_small ({name} chain)", proofs[0], vk2)

    tc = honk_crs.TestCrs()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_crs_", dir=ROOT) as tmp:
        g1, g2 = os.path.join(tmp, "g1.dat"), os.path.join(tmp, "g2.dat")
        honk_crs.write_g1_dat(g1, honk_crs.generate_test_setup_g1(64, tc.tau))
        with open(g2, "wb") as fh:
            for co in (tc.g2_x[0].c0, tc.g2_x[0].c1, tc.g2_x[1].c0, tc.g2_x[1].c1):
                fh.write(int(co.v).to_bytes(32, "big"))
        fc = honk_crs.FileCrs(g1, g2, 64, msm=honk_crs.driver_msm(PlainDriver(curve, device=device)))
    poly = [int.from_bytes(np.random.default_rng(66).bytes(32), "little") % p for _ in range(64)]
    kernels.reset_launch_counts()
    got = fc.commit(poly)
    torch.cuda.synchronize()
    msm_counts = kernels.launch_counts()
    want = tc.commit(poly)
    check((got[0].v, got[1].v) == (want[0].v, want[1].v),
          "honk_small: the driver_msm commit differs from TestCrs.commit")
    check(msm_counts["ec_madd"] > 0, "honk_small: the driver_msm commit launched no ec_madd")
    emit({"phase": "honk_small", "acvm_rep3_s": round(acvm_s, 3), "acvm_witness_slots": len(w),
          "acvm_launches": {k: v for k, v in acvm_counts.items() if v},
          "walls_s": {k: round(v, 3) for k, v in walls.items()}, "rounds_party0": rounds,
          "proof_launches": {k: v for k, v in proof_counts.items() if v},
          "driver_msm_launches": {k: v for k, v in msm_counts.items() if v},
          "proofs_equal_plain": True, "verified": True, "changed_public_refused": True,
          "shamir_rom_ram": "not run: the LUTs are REP3 only, as in the JAX package"})
    return add_counts(acvm_counts, proof_counts, msm_counts)


def phase_honk_full(curve, device, log_n: int) -> dict:
    """co-UltraHonk at n = 2^log_n rows under REP3: the Poseidon-style chain
    (tests/torch_port_util.poseidon_chain) built in code from a seed, its
    witness computed on the host and split into REP3 shares; three party
    threads, each building its own circuit and keys on the host, once (the
    noir_cli phase proves the same circuit again in three processes); the
    proofs equal, the host verifier accepts the proof and refuses a changed
    public input.  Returns the proof's launch counts."""
    from cocircom_tpu_torch.honk.builder import UltraCircuitBuilder, acir_to_format
    from cocircom_tpu_torch.honk.crs import TestCrs
    from cocircom_tpu_torch.honk.proving_key import create_keys
    from cocircom_tpu_torch.mpc.driver import PlainDriver
    from cocircom_tpu_torch.mpc.rep3 import share_field_vec
    from cocircom_tpu_torch.ops import kernels
    from cocircom_tpu_torch.ops.field import get_field

    u = noir_fixtures()
    rounds = honk_rounds(log_n)
    (c, _abi, w, _), fixture_s = honk_chain(u, log_n)
    t0 = time.perf_counter()
    af = acir_to_format(c)  # parsed once here, read by every party's builder
    acir_s = time.perf_counter() - t0
    f = get_field(curve.fr.p, curve.name + ".fr", device)
    shares = share_field_vec(f, f.encode(w), seed=67)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    proofs, wall, spans, rounds0 = honk_prove(curve, device, af, len(w), shares, "rep3", False,
                                              True)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(proofs[0] == proofs[1] == proofs[2], "honk_full: the parties' proofs differ")
    for k in ("mont_mul", "ec_add"):
        check(counts[k] > 0, f"honk_full: the proof launched no {k}")
    t0 = time.perf_counter()
    pk, vk = create_keys(UltraCircuitBuilder(af, [0] * len(w)),
                         TestCrs(driver=PlainDriver(curve, device=device)))
    vk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    honk_verify("honk_full", proofs[0], vk)
    verify_s = time.perf_counter() - t0
    emit({"phase": "honk_full", "rows": pk.circuit_size, "opcodes": len(c.opcodes),
          "poseidon_rounds": rounds, "witness_slots": len(w),
          "padding_rows": pk.circuit_size - (len(c.opcodes) + 19),
          "fixture_s": round(fixture_s, 2), "acir_to_format_s": round(acir_s, 2),
          "wall_s": round(wall, 3), "spans_party0": spans,
          "rounds_party0": rounds0, "peak_device_bytes": int(peak),
          "launches": {k: v for k, v in counts.items() if v},
          "vk_s": round(vk_s, 2), "verify_host_s": round(verify_s, 2),
          "proofs_identical": True, "verified": True, "changed_public_refused": True})
    return counts


def noir_cli_files(u, w, log_n: int) -> dict:
    """The noir_cli inputs: the ROM/RAM circuit with two providers' ABIs
    and Prover.toml files, the squaring chain and honk_full's 2^log_n-row
    chain as program JSON and witness stacks.  Returns the small
    fixtures' witnesses and inputs, the file sizes and the seconds."""
    from cocircom_tpu_torch.noir.acir import write_witness_stack

    t0 = time.perf_counter()
    c, abi, wit, inputs = u.memory_circuit(71)
    names = [q["name"] for q in abi["parameters"]]
    for k, part in enumerate((names[:2], names[2:])):
        sub = {"parameters": [q for q in abi["parameters"] if q["name"] in part]}
        with open(w(f"mem{k}.json"), "w") as fh:
            fh.write(u.acir_program_json(c, sub))
        with open(w(f"p{k}.toml"), "w") as fh:
            fh.write("".join(f'{nm} = "{hex(inputs[names.index(nm)])}"\n' for nm in part))
    with open(w("mem.json"), "w") as fh:
        fh.write(u.acir_program_json(c, abi))
    c2, abi2, w2, _ = u.squaring_chain(16, 72)
    (cf, abif, witf, _), _ = honk_chain(u, log_n)
    for name, (cc, aa, ww) in (("chain", (c2, abi2, w2)), ("full", (cf, abif, witf))):
        with open(w(f"{name}.json"), "w") as fh:
            fh.write(u.acir_program_json(cc, aa))
        with open(w(f"{name}.gz"), "wb") as fh:
            fh.write(write_witness_stack([(0, dict(enumerate(ww)))]))
    return {"mem_witness": wit, "mem_inputs": inputs,
            "file_bytes": {k: os.path.getsize(w(k)) for k in ("full.json", "full.gz")},
            "files_write_s": round(time.perf_counter() - t0, 2)}


def phase_noir_cli(curve, work: str, smi_line: str, log_n: int) -> dict:
    """The noir CLI (python -m cocircom_tpu_torch.noir.cli) as separate
    party processes on the card over mutual-TLS meshes (self-signed certs
    made here; plain TCP where `cryptography` does not import).  Every
    subcommand on the small circuits: split-input by two providers (two
    ABIs over the ROM/RAM circuit), merge-input-shares, three
    generate-witness (the REP3 co-ACVM; opened here and held to the
    fixture's witness), three translate-witness (the Shamir shares opened
    likewise); on the squaring chain split-witness, three generate-proof,
    create-vk, verify (accepts, and refuses a changed public input).  Then
    honk_full's 2^log_n-row chain (the same circuit and witness): three
    generate-proof processes (COCIRCOM_TRACE=1) with create-vk beside them,
    verify; proofs byte-equal and accepted; each party's spans, bytes, peak
    memory and launches.  Stages whose processes do not depend on each
    other run together.  Returns the summed launches of every
    generate-proof process."""
    from cocircom_tpu_torch.honk import prover
    from cocircom_tpu_torch.io.shares_io import _from_file
    from cocircom_tpu_torch.mpc import codec
    from cocircom_tpu_torch.mpc.net import gen_self_signed_cert
    from cocircom_tpu_torch.mpc.rep3 import Rep3FieldShare, combine_field_shares
    from cocircom_tpu_torch.mpc.shamir import combine_field_shares_shamir
    from cocircom_tpu_torch.ops.field import get_field

    u = noir_fixtures()
    w = lambda name: os.path.join(work, name)  # noqa: E731
    f = get_field(curve.fr.p, curve.name + ".fr", "cpu")
    run = CliRunner(work, module=NOIR_CLI)
    tls = tls_status()
    certs = None
    if tls is None:
        # made in this process: the cli phase runs gen-cert as processes
        certs = [(w(f"key{i}.pem"), w(f"cert{i}.pem")) for i in range(3)]
        for key, cert in certs:
            gen_self_signed_cert(key, cert, "localhost")
    ports = free_ports(3 * 4)
    mesh = {name: cli_mesh_configs(work, name, ports[3 * k: 3 * k + 3], certs)
            for k, name in enumerate(("witness", "translate", "prove", "full"))}
    files = noir_cli_files(u, w, log_n)

    def opened(paths, kind):
        objs = [codec.decode(open(pth, "rb").read()) for pth in paths]
        check(all(o["kind"] == kind for o in objs), f"noir_cli: a file is not {kind}")
        if kind == "noir-witness-shamir":
            return [int(v) for v in f.decode(combine_field_shares_shamir(
                f, [_from_file(np.asarray(o["a"]), "cpu") for o in objs], 1))]
        return [int(v) for v in f.decode(combine_field_shares(f, [
            Rep3FieldShare(_from_file(np.asarray(o["a"]), "cpu"),
                           _from_file(np.asarray(o["b"]), "cpu")) for o in objs]))]

    def launches_of(results):
        total = {}
        for _, _, err in results:
            for k, v in (parse_report(err)[1] or {}).items():
                total[k] = total.get(k, 0) + v
        return total

    run.stage("split", [["split-input", "--input", w(f"p{k}.toml"), "--circuit",
                         w(f"mem{k}.json"), "--out-dir", w(f"in{k}")] for k in range(2)]
              + [["split-witness", "--witness", w(f"{name}.gz"), "--circuit", w(f"{name}.json"),
                  "--out-dir", w(f"sw_{name}")] for name in ("chain", "full")], timeout=600)
    run.stage("merge", [["merge-input-shares", w(f"in0/p0.toml.{i}.shared"),
                         w(f"in1/p1.toml.{i}.shared"), "--out", w(f"merged.{i}.shared")]
                        for i in range(3)])
    check(opened([w(f"merged.{i}.shared") for i in range(3)], "noir-input")
          == files["mem_inputs"], "noir_cli: the merged inputs open to other values")
    res = run.stage("small", [["generate-witness", "--input", w(f"merged.{i}.shared"),
                               "--circuit", w("mem.json"), "--net-config", mesh["witness"][i],
                               "--out", w(f"wit.{i}.shared")] for i in range(3)]
                    + [["generate-proof", "--witness", w(f"sw_chain/witness.gz.{i}.shared"),
                        "--circuit", w("chain.json"), "--net-config", mesh["prove"][i],
                        "--out", w(f"proof.{i}")] for i in range(3)]
                    + [["create-vk", "--circuit", w("chain.json"), "--out", w("vk.json")]])
    check(opened([w(f"wit.{i}.shared") for i in range(3)], "noir-witness")
          == files["mem_witness"], "noir_cli: the co-ACVM's witness opens to other values")
    proofs = [open(w(f"proof.{i}"), "rb").read() for i in range(3)]
    check(proofs[0] == proofs[1] == proofs[2], "noir_cli: the parties' proof files differ")
    bad = prover.proof_from_buffer(proofs[0])
    bad[3] = (bad[3] + 1) % curve.fr.p
    with open(w("bad.proof"), "wb") as fh:
        fh.write(prover.proof_to_buffer(bad))
    res_v = run.stage("translate_verify",
                      [["translate-witness", "--witness", w(f"wit.{i}.shared"), "--net-config",
                        mesh["translate"][i], "--out", w(f"sh.{i}.shared")] for i in range(3)]
                      + [["verify", "--proof", w(pf), "--vk", w("vk.json")]
                         for pf in ("proof.0", "bad.proof")], expect=[0, 0, 0, 0, 1])
    check(opened([w(f"sh.{i}.shared") for i in range(3)], "noir-witness-shamir")
          == files["mem_witness"], "noir_cli: the Shamir witness opens to other values")
    check("verification: OK" in res_v[3][1], "noir_cli: verify did not accept the proof")
    check("verification: FAILED" in res_v[4][1],
          "noir_cli: verify accepted a changed public input")
    small = {"launches": launches_of(res[3:6]), "proofs_identical": True, "verified": True,
             "changed_public_refused": True, "witness_opened": True}

    t0 = time.perf_counter()
    res = run.stage("full_prove", [["generate-proof", "--witness",
                                    w(f"sw_full/witness.gz.{i}.shared"), "--circuit",
                                    w("full.json"), "--net-config", mesh["full"][i], "--out",
                                    w(f"full.proof.{i}")] for i in range(3)]
                    + [["create-vk", "--circuit", w("full.json"), "--out", w("full.vk.json")]],
                    timeout=900)
    wall = time.perf_counter() - t0
    proofs = [open(w(f"full.proof.{i}"), "rb").read() for i in range(3)]
    check(proofs[0] == proofs[1] == proofs[2], "noir_cli: the 2^20 parties' proof files differ")
    res_v = run.stage("full_verify", [["verify", "--proof", w("full.proof.0"), "--vk",
                                       w("full.vk.json")]])
    check("verification: OK" in res_v[0][1], "noir_cli: verify did not accept the 2^20 proof")
    parties = []
    for i, (_, _, err) in enumerate(res[:3]):
        spans, launches, peak, setup, waits = parse_report(err)
        missing = [k for k in NOIR_CLI_KERNELS if not (launches or {}).get(k)]
        check(not missing, f"noir_cli: party {i}'s report shows no launch of {missing}")
        prove = spans.get("generate-proof ultrahonk")
        check(prove is not None, f"noir_cli: party {i}'s report lacks the prove span: {spans}")
        parties.append({"spans": {k: round(v[0], 3) for k, v in spans.items()},
                        "sent_bytes": prove[1], "recv_bytes": prove[2],
                        "peak_device_bytes": peak, "launches": launches,
                        "launches_setup": setup, "waits": waits})
    full = {"rows": 1 << log_n, "files_write_s": files["files_write_s"],
            "file_bytes": files["file_bytes"], "parties": parties,
            "wall_spawn_to_last_exit_s": round(wall, 3), "proofs_identical": True,
            "verified": True, "launches": launches_of(res[:3])}
    emit({"phase": "noir_cli", "tls": "mutual, pinned certificates" if tls is None else tls,
          "small": small, "full": full, "stage_seconds": run.seconds, "device": smi_line})
    return add_counts(small["launches"], full["launches"])


def free_ports(n: int) -> list:
    """n distinct free localhost ports (bound to port 0 together, released)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


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
    ap.add_argument("--honk-log", type=int, default=HONK_LOG)
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
    full_sized = [p for p in ("prove_full", "prove_sharded", "prove_shamir", "cli")
                  if p in phases]
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
    runs = {"prove_small": zero, "prove_full_cold": zero, "prove_sharded": zero,
            "prove_shamir": zero, "prove_bls": zero, "plonk_small": zero, "plonk_full": zero,
            "vm_small": zero, "vm_full": zero, "cli": zero, "honk_small": zero,
            "honk_full": zero, "noir_cli": zero}
    if "prove_small" in phases:
        runs["prove_small"] = phase_prove_small(curve, device, SMALL_MULS)
    inputs = None
    if full_sized:
        inputs = full_inputs(curve, device, args.full_log, torch.Generator().manual_seed(4242))
    warm_prove_full, warm_counts = "not run", None
    if "prove_full" in phases:
        runs["prove_full_cold"], warm_prove_full, warm_counts = phase_prove_full(
            curve, device, args.full_log,
                                                                    inputs)
    if "prove_sharded" in phases:
        runs["prove_sharded"] = phase_prove_sharded(curve, device, args.full_log, inputs)
    if "prove_shamir" in phases:
        runs["prove_shamir"] = phase_prove_shamir(curve, device, args.full_log, inputs)
    cli_work = cli_prepared = None
    if "cli" in phases:
        # the 2^20 key and shares go to files now; the parties start after
        # the other phases, once this process has let go of the card
        cli_work = tempfile.mkdtemp(prefix=".chip_smoke_cli_", dir=ROOT)
        cli_prepared = cli_prepare_full(curve, device, inputs, cli_work)
    del inputs
    if "prove_bls" in phases:
        runs["prove_bls"] = phase_prove_bls(device, BLS_MULS)
    if "plonk_small" in phases:
        runs["plonk_small"] = phase_plonk_small(device)
    if "plonk_full" in phases:
        runs["plonk_full"] = phase_plonk_full(curve, device, PLONK_LOG)
    if "vm_small" in phases:
        runs["vm_small"] = phase_vm_small(device)
    if "vm_full" in phases:
        runs["vm_full"] = phase_vm_full(curve, device, VM_FULL_N)
    if "cli" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        try:
            runs["cli"] = phase_cli(curve, device, cli_work, cli_prepared,
                                    (warm_prove_full, warm_counts), smi_line)
        finally:
            shutil.rmtree(cli_work, ignore_errors=True)
    if "honk_small" in phases:
        runs["honk_small"] = phase_honk_small(curve, device)
    if "honk_full" in phases:
        runs["honk_full"] = phase_honk_full(curve, device, args.honk_log)
    if "noir_cli" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        noir_work = tempfile.mkdtemp(prefix=".chip_smoke_noir_", dir=ROOT)
        try:
            runs["noir_cli"] = phase_noir_cli(curve, noir_work, smi_line, args.honk_log)
        finally:
            shutil.rmtree(noir_work, ignore_errors=True)
    _HONK_CHAINS.clear()
    if "honk_profile" in phases:
        phase_honk_profile(curve, device, args.honk_log)
    if "graft" in phases:
        phase_graft(curve, device)
    counts = {k: sum(r.get(k, 0) for r in runs.values()) for k in kernels.COUNT_KEYS}
    emit({"phase": "launches", **{name: {k: v for k, v in r.items() if v}
                                  for name, r in runs.items()}})

    if set(phases) != set(ALL_PHASES):
        if rows:
            emit({"kernels": rows})
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
