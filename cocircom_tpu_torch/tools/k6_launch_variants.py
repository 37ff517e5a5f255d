#!/usr/bin/env python3
"""Time launch-shape variants of the CUDA kernel `ec_wave_add` on one GPU.

Run from the repository root on a machine with an NVIDIA card and nvcc:

    python3 -m cocircom_tpu_torch.tools.k6_launch_variants

The committed source (cocircom_tpu_torch/csrc/ec_wave_add.cu) fixes a block
size and a `__launch_bounds__` for each limb count.  This script rewrites
those two things in copies of the source (block sizes 64, 128, 256; caps of
2 to 8 blocks an SM, i.e. 255 down to 96 registers a thread), builds every
copy with the package's own nvcc flags, runs each at the shape of one wave
of a c = 12 MSM ((L, 22, 2049, 8) lanes, 80% valid, half negated) for 8 and
for 12 limbs, checks that all copies give the same bits, and prints one JSON
line per copy: milliseconds per launch (a CUDA graph of 50 launches timed
with CUDA events, three times), registers and spill bytes as ptxas reports
them.  Without a card it exits 2.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..fields.params import BLS12_381, BN254
from ..ops import kernels

# (threads a block, least blocks an SM; None = no cap)
SHAPES = [(128, None), (64, None), (256, None), (128, 3), (128, 4), (64, 8), (256, 2), (128, 5)]
THREADS = re.compile(r"static constexpr int threads = [^;]+;")
BLOCKS = re.compile(r"static constexpr int min_blocks = [^;]+;")
BOUNDS = "__launch_bounds__(WaveLaunch<L>::threads, WaveLaunch<L>::min_blocks)"


def variant(src: str, threads: int, blocks) -> str:
    out = THREADS.sub(f"static constexpr int threads = {threads};", src)
    if blocks is None:
        return out.replace(BOUNDS, "")
    return BLOCKS.sub(f"static constexpr int min_blocks = {blocks};", out)


def time_graph(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas(log: str, limbs: int):
    body = log[log.index(f"ec_wave_add_kernelILi{limbs}E"):]
    regs = int(re.search(r"Used (\d+) registers", body).group(1))
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
    return regs, int(spill.group(1)), int(spill.group(2))


def main() -> None:
    if not torch.cuda.is_available():
        print("k6_launch_variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from ..ops.curve import g1_ops

    src = (kernels.CSRC / "ec_wave_add.cu").read_text()
    if not (THREADS.search(src) and BLOCKS.search(src) and BOUNDS in src):
        sys.exit("k6_launch_variants: the source no longer has the launch shape this script edits")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        procs = []
        for threads, blocks in SHAPES:
            name = f"t{threads}_b{blocks}"
            (out / f"{name}.cu").write_text(variant(src, threads, blocks))
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                   "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
            procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
        logs = {}
        for name, proc in procs:
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                sys.exit(f"nvcc failed for {name}:\n{logs[name]}")

        gen = torch.Generator().manual_seed(1)
        n = 22 * 2049 * 8
        for curve in (BN254, BLS12_381):
            ops = g1_ops(curve, "cuda")
            f = ops.lane.f
            L = f.L

            def rnd():
                raw = torch.randint(0, 1 << 32, (L, n), generator=gen, dtype=torch.int64)
                raw[L - 1] &= (1 << (f.bits - 32 * (L - 1))) - 1
                return f._cond_sub_p(raw.to(torch.int32).cuda())

            acc = [rnd() for _ in range(3)]
            rows = torch.cat([rnd() for _ in range(3)], dim=0).t().contiguous()
            valid = (torch.rand(n, generator=gen) < 0.8).cuda()
            neg = (torch.rand(n, generator=gen) < 0.5).cuda()
            first = None
            for name in logs:
                fn = ctypes.CDLL(str(out / f"lib{name}.so")).cc_ec_wave_add
                fn.argtypes = kernels._ARGTYPES["ec_wave_add"]
                fn.restype = ctypes.c_int
                work = [c.clone() for c in acc]

                def run():
                    err = fn(*(c.data_ptr() for c in work), rows.data_ptr(), neg.data_ptr(),
                             valid.data_ptr(), n, L, ctypes.addressof(ops._kconsts),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        sys.exit(f"{name}: launch failed (cudaError {err})")

                run()
                torch.cuda.synchronize()
                res = torch.stack(work)
                first = res if first is None else first
                regs, st, ld = ptxas(logs[name], L)
                print(json.dumps({
                    "limbs": L, "variant": name, "same_bits_as_first": bool(torch.equal(res, first)),
                    "ms": [time_graph(run) for _ in range(3)], "registers": regs,
                    "spill_store_bytes": st, "spill_load_bytes": ld}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
