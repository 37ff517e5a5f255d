"""The carry-chain arithmetic and the cooperative curve kernels of the CUDA
sources, run on the CPU through their host model
(cocircom_tpu_torch/tools/carry_model.cpp: csrc/field.cuh, csrc/curve.cuh,
csrc/ec_add.cu, csrc/ec_add_g2.cu and csrc/ec_wave_add_g2.cu compiled with g++, each
PTX carry instruction emulated, each warp run as 32 fibers of one host
thread that meet at every shuffle).

Field operations are held to Python integers (random and edge operands,
both limb counts, the four fields of the two curves); the kernels `ec_add`
(teams of 1 and 3 threads a lane), `ec_add_g2` (a pair a lane) and
`ec_wave_add_g2` to their plain PyTorch versions, bit for bit, with edge
lanes, broadcast operands, tails and a grid that strides.  This checks the
sources' arithmetic and lane logic, not the compiler of the card: the card
checks are chip_smoke.py's.
"""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cocircom_tpu_torch.fields.params import BLS12_381, BN254
from cocircom_tpu_torch.ops.curve import (ProjPoint, ec_add_g2_plain, ec_add_plain,
                                          ec_wave_add_g2_plain, g1_ops, g2_ops, leaves, pmap)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "cocircom_tpu_torch" / "csrc"
MODEL = ROOT / "cocircom_tpu_torch" / "tools" / "carry_model.cpp"


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the host model cannot be built")
    exe = tmp_path_factory.mktemp("carry_model") / "carry_model"
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-I", str(CSRC), "-o", str(exe),
                    str(MODEL)], check=True, timeout=300)
    return exe


def _words(x: int, n: int) -> str:
    return " ".join("%08x" % ((x >> (32 * i)) & 0xFFFFFFFF) for i in range(n))


def _hex(t: torch.Tensor) -> str:
    return " ".join("%08x" % v for v in (t.to(torch.int64) & 0xFFFFFFFF).reshape(-1).tolist())


def _run(exe, L: int, consts, body: str) -> list:
    inp = f"{L}\n{' '.join('%08x' % w for w in consts)}\n{body}"
    out = subprocess.run([str(exe)], input=inp, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split("\n")[:-1]


def _limbs(line: str, L: int) -> torch.Tensor:
    v = np.array([int(w, 16) for w in line.split()], dtype=np.uint32).view(np.int32)
    return torch.from_numpy(v.copy()).reshape(L, -1)


@pytest.mark.parametrize("p,L", [(BN254.fq.p, 8), (BN254.fr.p, 8), (BLS12_381.fq.p, 12),
                                 (BLS12_381.fr.p, 8)],
                         ids=["bn254_fq", "bn254_fr", "bls12_381_fq", "bls12_381_fr"])
def test_field_ops_match_integers(model, p, L):
    R = 1 << (32 * L)
    r_inv = pow(R, -1, p)
    n0inv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    consts = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(L)] + [n0inv] + [0] * (2 * L)
    rng = random.Random(L * 1000 + p % 997)
    edge = [0, 1, 2, p - 1, p - 2, (1 << 32) - 1, R % p, p >> 1, (p >> 1) + 1]
    vals = edge + [rng.randrange(p) for _ in range(60)]
    ops, want = [], []

    def op(name, args, widths, value):
        ops.append(name + " " + " ".join(_words(a, w) for a, w in zip(args, widths)))
        want.append(value)

    for i in range(150):
        a, b = (vals[i % len(vals)], vals[(7 * i + 3) % len(vals)]) if i < 81 else \
            (rng.choice(vals), rng.choice(vals))
        c, d = rng.choice(vals), rng.choice(vals)
        op("mul", (a, b), (L, L), a * b * r_inv % p)
        if 4 * p < R:        # mont_sum2_cc needs two spare bits (the two Fq)
            op("sum2", (a, b, c, d), (L,) * 4, (a * b + c * d) * r_inv % p)
        op("add", (a, b), (L, L), (a + b) % p)
        op("sub", (a, b), (L, L), (a - b) % p)
        op("pminus", (b,), (L,), p - b)
    # the largest sums of products (p - b stands in for -b, so b = 0 gives p)
    for a, b, c, d in [(p - 1, p - 1, p - 1, p - 1), (p - 1, p - 1, p - 1, p), (0, 0, 0, 0),
                       (p - 1, (1 << 32) - 1, p - 1, p)]:
        if 4 * p < R:
            op("sum2", (a, b, c, d), (L,) * 4, (a * b + c * d) * r_inv % p)
    got = _run(model, L, consts, "\n".join(ops) + "\n")
    assert len(got) == len(want)
    bad = [(o.split()[0], g) for o, g, w in zip(ops, got, want)
           if sum(int(x, 16) << (32 * i) for i, x in enumerate(g.split())) != w]
    assert not bad, bad[:5]


def _shape_for(n: int, threads: int, per_warp: int):
    """(blocks, threads) as the cooperative kernels' launchers pick them
    (csrc/field.cuh `shape_for`)."""
    warps = -(-n // per_warp)
    threads = min(threads, warps * 32)
    return -(-n // ((threads // 32) * per_warp)), threads


def _rand(f, n: int, rng) -> torch.Tensor:
    """n canonical Montgomery elements of f from a numpy generator."""
    return f.encode([int.from_bytes(rng.bytes(4 * f.L), "little") % f.p for _ in range(n)])


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
def test_cooperative_kernels_match_plain_versions(model, curve):
    """Coordinates are random field elements (the complete formula is the
    same polynomial map for any), with lanes of the identity, of doubling
    and of inverse points set up by hand."""
    rng = np.random.default_rng(3)
    # ---- K4 ec_add: teams of 1 and 3; 13 lanes with edge lanes, and 2 lanes
    g1 = g1_ops(curve, "cpu")
    f, L = g1.lane.f, g1.lane.f.L
    one, zero = f.one_mont((2,)), f.zeros((2,))
    consts = list(g1._kconsts)
    for n in (2, 13):
        P = ProjPoint(*(_rand(f, n, rng) for _ in range(3)))
        Q = ProjPoint(*(_rand(f, n, rng) for _ in range(3)))
        if n == 13:            # identity + Q, P + P, P + (-P), P + identity
            for i, c in enumerate((zero, one, zero)):
                P[i][:, :2] = c
                Q[i][:, 4:6] = P[i][:, 4:6]
                Q[i][:, 6:8] = f.neg(P[i][:, 6:8]) if i == 1 else P[i][:, 6:8]
                Q[i][:, 8:10] = c
        for pb, qb in ((0, 0), (0, 1), (1, 0)):
            Pp = pmap(lambda c: c[:, :1], P) if pb else P
            Qq = pmap(lambda c: c[:, -1:], Q) if qb else Q
            want = ec_add_plain(f, g1._b3_mont, Pp, Qq)
            grids = [(S, *_shape_for(n, 128, 32 // S)) for S in (1, 3)] + [(3, 1, 32)]
            body = "".join(
                f"g1add {S} {n} {pb} {qb} {b} {t} " + " ".join(_hex(c) for c in list(Pp) + list(Qq))
                + "\n" for S, b, t in grids)
            lines = _run(model, L, consts, body)
            for j in range(0, len(lines), 3):
                for g, w in zip(lines[j:j + 3], want):
                    assert torch.equal(_limbs(g, L), w.reshape(L, -1)), (n, pb, qb, grids[j // 3])
    # ---- the G2 add: a pair a lane; 20 lanes with edge lanes, and one lane
    g2 = g2_ops(curve, "cpu")
    consts = list(g2._kconsts)
    ident = (zero, zero, one, zero, zero, zero)      # (0 : 1 : 0) over Fq2
    for n in (1, 20):
        P = [_rand(f, n, rng) for _ in range(6)]
        Q = [_rand(f, n, rng) for _ in range(6)]
        if n == 20:
            for i in range(6):
                P[i][:, :2] = ident[i]
                Q[i][:, 4:6] = P[i][:, 4:6]
                Q[i][:, 6:8] = f.neg(P[i][:, 6:8]) if i in (2, 3) else P[i][:, 6:8]
                Q[i][:, 8:10] = ident[i]
        for pb in (0, 1):
            Pp = [c[:, :1] for c in P] if pb else P
            pt = lambda cs: ProjPoint(*((cs[2 * k], cs[2 * k + 1]) for k in range(3)))  # noqa: E731
            want = leaves(ec_add_g2_plain(g2, pt(Pp), pt(Q)))
            body = "".join(f"g2add {n} {pb} 0 {b} {t} " + " ".join(_hex(c) for c in Pp + Q) + "\n"
                           for b, t in (_shape_for(n, 128, 16), (1, 32)))
            lines = _run(model, L, consts, body)
            for j in range(0, len(lines), 6):
                for g, w in zip(lines[j:j + 6], want):
                    assert torch.equal(_limbs(g, L), w), (n, pb, j // 6)
    # ---- the G2 wave: 40 lanes, edge lanes, masked lanes and a masked warp
    n = 40
    acc = [_rand(f, n, rng) for _ in range(6)]
    rows = torch.cat([_rand(f, n, rng) for _ in range(6)], dim=0).t().contiguous()
    neg = torch.from_numpy(rng.random(n) < 0.5)
    valid = torch.from_numpy(rng.random(n) < 0.7)
    for a, c in zip(acc, ident):
        a[:, :4] = c[:, :1]                                            # identity accumulator
    rows[4:8] = torch.cat([c[:, :1] for c in ident], dim=0).t()        # identity point
    rows[8:16] = torch.cat(acc, dim=0).t()[8:16]                       # doubling, inverse
    neg[8:12], neg[12:16] = False, True
    valid[:16] = True
    rows[16:20], valid[16:20] = 0, False                               # masked, zero rows
    valid[20:36] = False                                               # a whole warp masked
    accp = ProjPoint(*((acc[2 * k], acc[2 * k + 1]) for k in range(3)))
    want = leaves(ec_wave_add_g2_plain(g2, accp, rows, neg, valid))
    body = "".join(f"g2wave {n} {b} {t} " + " ".join(_hex(c) for c in acc) + " "
                   + " ".join(_hex(x) for x in (rows, neg.to(torch.int32), valid.to(torch.int32)))
                   + "\n" for b, t in (_shape_for(n, 128, 16), (1, 32)))
    lines = _run(model, L, consts, body)
    for j in range(0, len(lines), 6):
        for g, w in zip(lines[j:j + 6], want):
            assert torch.equal(_limbs(g, L), w), j // 6
