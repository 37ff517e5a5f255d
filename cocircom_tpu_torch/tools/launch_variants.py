#!/usr/bin/env python3
"""Time launch-shape and design variants of the curve kernels on one GPU.

Run from the repository root on a machine with an NVIDIA card and nvcc:

    python3 -m cocircom_tpu_torch.tools.launch_variants            # both sets
    python3 -m cocircom_tpu_torch.tools.launch_variants --only ec_add
    python3 -m cocircom_tpu_torch.tools.launch_variants --only ec_wave_add

Two sets of variants, each built from copies of a committed source with the
package's own nvcc flags, all copies of a set built in parallel:

  ec_wave_add  (K6, csrc/ec_wave_add.cu) block sizes 64, 128, 256 and caps of
               2 to 8 blocks an SM (255 down to 96 registers a thread), timed
               at the shape of one wave of a c = 12 MSM ((L, 22, 2049, 8)
               lanes, 80% valid, half negated).
  ec_add       the cooperative curve kernels, one source each: K4 `ec_add`
               (csrc/ec_add.cu), `ec_add_g2` (csrc/ec_add_g2.cu) and
               `ec_wave_add_g2` (csrc/ec_wave_add_g2.cu).  Each source as
               committed, with K4's team size fixed at 1 or 3 threads a lane
               at every lane count, and with other block sizes and register
               caps; and as the yardstick the one-lane-a-thread design that
               those sources replaced (tools/ec_add_one_lane.cu: the 64-bit
               CIOS product, blocks of 128, the G2 product not inlined).
               K4 is timed at its reduction shape (L, 22, 2048), at 1, 2,
               1,024, 1,408 (22 x 64), 2,048, 4,096, 8,192 and 11,264
               (22 x 512) lanes, which places the lane count where the
               launcher switches team size; the G2 add at (L, 22, 2049, 8)
               and at 1 and 2 lanes; the G2 wave at (L, 22, 2049, 8), 80%
               valid, half negated.

Both limb counts (8: BN254, 12: BLS12-381).  Every variant runs on the same
inputs.  The ec_add set runs one entry point at a time, each in processes of
its own: first every variant alone (a fault takes down only its process; a
variant that faults, or whose bits differ from those most variants give, is
reported and not timed), then all that passed in one process, in turns.
A variant is named by its changes to the committed launch lines
(`committed` for none).
The script prints one JSON line per variant, limb count and shape:
milliseconds per launch (a CUDA graph of launches timed with CUDA events;
the variants take turns, three rounds), and per kernel instantiation the
registers, stack and spill bytes `ptxas` reports and, where the toolkit has
`cuobjdump`, the static count of IMAD* and of IADD3/IADD instructions (per
thread, and per lane: times the threads that serve a lane).  Then the
card's name and power limit.  Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..fields.params import BLS12_381, BN254
from ..ops import kernels

TOOLS = Path(__file__).resolve().parent

# ---- K6: (threads a block, least blocks an SM; None = no cap)
SHAPES = [(128, None), (64, None), (256, None), (128, 3), (128, 4), (64, 8), (256, 2), (128, 5)]
THREADS = re.compile(r"static constexpr int threads = [^;]+;")
BLOCKS = re.compile(r"static constexpr int min_blocks = [^;]+;")
BOUNDS = "__launch_bounds__(WaveLaunch<L>::threads, WaveLaunch<L>::min_blocks)"

# ---- the cooperative kernels: {entry point: (source, launch struct,
# variants)}; a variant is a name and changes to the fields of the launch
# lines of both limb counts (none: the source as committed)
EC_ADD_SETS = {
    "ec_add": ("ec_add.cu", "AddLaunch", [
        ("committed", {}), ("team1", {"team": 1, "team_small": 1}),
        ("team3", {"team": 3, "team_small": 3}), ("t64", {"threads": 64, "min_blocks": 1}),
        ("t128_b4", {"threads": 128, "min_blocks": 4})]),
    "ec_add_g2": ("ec_add_g2.cu", "G2Launch", [
        ("committed", {}), ("t64", {"threads": 64, "min_blocks": 1}),
        ("t128", {"threads": 128, "min_blocks": 1}),
        ("t128_b3", {"threads": 128, "min_blocks": 3})]),
    "ec_wave_add_g2": ("ec_wave_add_g2.cu", "G2WaveLaunch", [
        ("committed", {}), ("t128", {"threads": 128, "min_blocks": 1}),
        ("t128_b3", {"threads": 128, "min_blocks": 3})]),
}
LAUNCH_LINE = re.compile(r"template <> struct (\w+)<(8|12)> \{ static constexpr int ([^;]*); \};")
YARDSTICK = "one_lane"


def variant(src: str, threads: int, blocks) -> str:
    out = THREADS.sub(f"static constexpr int threads = {threads};", src)
    if blocks is None:
        return out.replace(BOUNDS, "")
    return BLOCKS.sub(f"static constexpr int min_blocks = {blocks};", out)


def ec_add_variant(src: str, struct: str, changes: dict) -> str:
    """`src` with `changes` made to the fields of its `struct` launch lines."""
    def line(m):
        if m.group(1) != struct:
            return m.group(0)
        fields = dict(f.split(" = ") for f in m.group(3).split(", "))
        fields.update({k: str(v) for k, v in changes.items()})
        body = ", ".join(f"{k} = {v}" for k, v in fields.items())
        return f"template <> struct {struct}<{m.group(2)}> {{ static constexpr int {body}; }};"
    return LAUNCH_LINE.sub(line, src)


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


def build(out: Path, sources: dict) -> dict:
    """{name: .cu text} -> {name: nvcc log}; one nvcc each, all at once."""
    procs = []
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
               "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    logs = {}
    for name, proc in procs:
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{logs[name]}")
    return logs


def sass_counts(lib: Path) -> dict:
    """{kernel instantiation: {"imad": n, "iadd": n}} from cuobjdump -sass,
    or {} where the toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return {}
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            e = re.search(r"_Z\d+([a-z0-9_]+?)_kernelILi(\d+)E(?:Li(\d+)E)?", m.group(1))
            cur = None
            if e:
                cur = f"{e.group(1)}_l{e.group(2)}" + (f"_s{e.group(3)}" if e.group(3) else "")
                out[cur] = {"imad": 0, "iadd": 0}
            continue
        if cur and re.search(r"\bIMAD", line):
            out[cur]["imad"] += 1
        elif cur and re.search(r"\bIADD3?\b|\bIADD3\.", line):
            out[cur]["iadd"] += 1
    return out


def load(lib: Path, name: str):
    fn = getattr(ctypes.CDLL(str(lib)), f"cc_{name}")
    fn.argtypes = kernels._ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _checked(fn, name, *args):
    err = fn(*args)
    if err:
        sys.exit(f"{name}: launch failed (cudaError {err})")


def rand_elems(f, n, gen):
    raw = torch.randint(0, 1 << 32, (f.L, n), generator=gen, dtype=torch.int64)
    raw[f.L - 1] &= (1 << (f.bits - 32 * (f.L - 1))) - 1
    return f._cond_sub_p(raw.to(torch.int32).cuda())


def smi_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- K6 variants

def run_k6(tmp: Path) -> None:
    from ..ops.curve import g1_ops

    src = (kernels.CSRC / "ec_wave_add.cu").read_text()
    if not (THREADS.search(src) and BLOCKS.search(src) and BOUNDS in src):
        sys.exit("launch_variants: ec_wave_add.cu no longer has the launch shape this script edits")
    logs = build(tmp, {f"k6_t{t}_b{b}": variant(src, t, b) for t, b in SHAPES})
    gen = torch.Generator().manual_seed(1)
    n = 22 * 2049 * 8
    for curve in (BN254, BLS12_381):
        ops = g1_ops(curve, "cuda")
        f = ops.lane.f
        L = f.L
        acc = [rand_elems(f, n, gen) for _ in range(3)]
        rows = torch.cat([rand_elems(f, n, gen) for _ in range(3)], dim=0).t().contiguous()
        valid = (torch.rand(n, generator=gen) < 0.8).cuda()
        neg = (torch.rand(n, generator=gen) < 0.5).cuda()
        first = None
        for name in logs:
            fn = load(tmp / f"lib{name}.so", "ec_wave_add")
            work = [c.clone() for c in acc]

            def run():
                _checked(fn, name, *(c.data_ptr() for c in work), rows.data_ptr(),
                         neg.data_ptr(), valid.data_ptr(), n, L, ctypes.addressof(ops._kconsts),
                         _stream())

            run()
            torch.cuda.synchronize()
            res = torch.stack(work)
            first = res if first is None else first
            info = kernels.parse_ptxas(logs[name]).get(f"ec_wave_add_l{L}", {})
            print(json.dumps({
                "set": "ec_wave_add", "limbs": L, "variant": name,
                "same_bits_as_first": bool(torch.equal(res, first)),
                "ms": [time_graph(run) for _ in range(3)], **info}), flush=True)


# --------------------------------------------------------- ec_add variants

ENTRIES = ("ec_add", "ec_add_g2", "ec_wave_add_g2")


def ec_add_cases(curve, entry: str) -> dict:
    """{shape name: make} for one entry point over one curve; make(fn,
    name) builds a launcher from a library's entry point and returns (run,
    result).  Each shape's inputs come from a generator of its own, so any
    process builds the same ones."""
    from ..ops.curve import g1_ops, g2_ops

    g1, g2 = g1_ops(curve, "cuda"), g2_ops(curve, "cuda")
    f = g1.lane.f
    L = f.L

    def g1_case(n, seed):
        gen = torch.Generator().manual_seed(seed)
        ins = [rand_elems(f, n, gen) for _ in range(6)]
        outs = [torch.empty_like(ins[0]) for _ in range(3)]

        def make(fn, name):
            def run():
                _checked(fn, name, *(t.data_ptr() for t in ins + outs), n, 0, 0, L,
                         ctypes.addressof(g1._kconsts), _stream())
            return run, lambda: torch.stack(outs).clone()
        return make

    def g2_case(n, seed):
        gen = torch.Generator().manual_seed(seed)
        ins = [rand_elems(f, n, gen) for _ in range(12)]
        outs = [torch.empty_like(ins[0]) for _ in range(6)]
        ip = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in ins))
        op = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in outs))

        def make(fn, name):
            def run(_keep=ins):   # the pointer table holds no reference to the tensors
                _checked(fn, name, ctypes.addressof(ip), ctypes.addressof(op), n, 0, 0, L,
                         ctypes.addressof(g2._kconsts), _stream())
            return run, lambda: torch.stack(outs).clone()
        return make

    def wave_case(n, seed):
        gen = torch.Generator().manual_seed(seed)
        acc = [rand_elems(f, n, gen) for _ in range(6)]
        rows = torch.cat([rand_elems(f, n, gen) for _ in range(6)], dim=0).t().contiguous()
        valid = (torch.rand(n, generator=gen) < 0.8).cuda()
        neg = (torch.rand(n, generator=gen) < 0.5).cuda()

        def make(fn, name):
            work = [c.clone() for c in acc]
            ap = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in work))
            once = {"done": False}

            def run():
                _checked(fn, name, ctypes.addressof(ap), rows.data_ptr(), neg.data_ptr(),
                         valid.data_ptr(), n, L, ctypes.addressof(g2._kconsts), _stream())

            def result():
                # the first launch's result: in-place updates accumulate
                if not once["done"]:
                    once["done"] = True
                    once["res"] = torch.stack(work).clone()
                return once["res"]
            return run, result
        return make

    if entry == "ec_add":
        return {f"ec_add_l{L}_(22,2048)": g1_case(22 * 2048, 1),
                **{f"ec_add_l{L}_{n}_lanes": g1_case(n, 10 + i)
                   for i, n in enumerate((1, 2, 1024, 1408, 2048, 4096, 8192, 11264))}}
    if entry == "ec_add_g2":
        return {f"ec_add_g2_l{L}_(22,2049,8)": g2_case(22 * 2049 * 8, 5),
                f"ec_add_g2_l{L}_1_lane": g2_case(1, 6),
                f"ec_add_g2_l{L}_2_lanes": g2_case(2, 7)}
    return {f"ec_wave_add_g2_l{L}_(22,2049,8)": wave_case(22 * 2049 * 8, 8)}


def check_variant(tmp: Path, name: str, entry: str) -> None:
    """Child process: every shape of one entry point of variant `name` once,
    each launch synchronised (CUDA_LAUNCH_BLOCKING=1 in the environment).
    Prints a line before each launch, so that the last line names a launch
    that faulted, and last a line of digests of the results.  A fault that
    corrupts a CUDA context takes only this process down."""
    digests = {}
    for curve in (BN254, BLS12_381):
        for shape, make in ec_add_cases(curve, entry).items():
            print(json.dumps({"launching": shape}), flush=True)
            run, result = make(load(tmp / f"lib{name}.so", entry), name)
            run()
            torch.cuda.synchronize()
            digests[shape] = hashlib.sha256(result().cpu().numpy().tobytes()).hexdigest()[:16]
    print(json.dumps({"variant": name, "digests": digests}), flush=True)


def _child(args: list, env=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "cocircom_tpu_torch.tools.launch_variants",
                             *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=str(TOOLS.parent.parent))


def checked_variants(tmp: Path, names, entry: str) -> list:
    """The variants that ran every shape of `entry` without a fault and gave
    the bits that most variants gave; the children run four at a time."""
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING="1")
    names, digests = list(names), {}
    for i in range(0, len(names), 4):
        procs = [(n, _child(["--check", n, "--entry", entry, "--dir", str(tmp)], env))
                 for n in names[i:i + 4]]
        for n, proc in procs:
            out, _ = proc.communicate()
            last = out.strip().splitlines()[-1] if out.strip() else ""
            if proc.returncode == 0 and '"digests"' in last:
                digests[n] = json.loads(last)["digests"]
            else:
                print(json.dumps({"set": "ec_add", "entry": entry, "variant": n,
                                  "check_failed": True, "output": out[-2500:]}), flush=True)
    if not digests:
        return []
    keys = [json.dumps(d, sort_keys=True) for d in digests.values()]
    want = json.loads(max(set(keys), key=keys.count))
    good = []
    for n, d in digests.items():
        if d == want:
            good.append(n)
        else:
            print(json.dumps({"set": "ec_add", "entry": entry, "variant": n, "check_failed": True,
                              "differs_at": [k for k in d if d[k] != want.get(k)]}), flush=True)
    return good


def _per_lane(name: str, key: str) -> int:
    """Threads that serve a lane in kernel instantiation `key` of `name`."""
    if name == YARDSTICK:
        return 1
    m = re.search(r"_s(\d+)$", key)
    return int(m.group(1)) if m else 2      # K4's team size, else a pair (G2)


def time_entry(tmp: Path, entry: str, names: list, rounds: int) -> None:
    """Child process: the variants `names` of one entry point take turns at
    each of its shapes; one line per variant and shape."""
    info = {n: kernels.parse_ptxas((tmp / f"lib{n}.log").read_text()) for n in names}
    sass = {n: json.loads((tmp / f"lib{n}.sass.json").read_text()) for n in names}
    for curve in (BN254, BLS12_381):
        for shape, make in ec_add_cases(curve, entry).items():
            L = 8 if "_l8_" in shape else 12
            runs = {n: make(load(tmp / f"lib{n}.so", entry), n) for n in names}
            results, times = {}, {n: [] for n in names}
            for n, (run, result) in runs.items():
                run()
                torch.cuda.synchronize()
                results[n] = result()
            reps = 20 if "(22," in shape else 200
            for _ in range(rounds):
                for n, (run, _) in runs.items():
                    times[n].append(time_graph(run, reps))
            for n in names:
                keys = [k for k in info[n]
                        if k == f"{entry}_l{L}" or k.startswith(f"{entry}_l{L}_s")]
                print(json.dumps({
                    "set": "ec_add", "shape": shape, "variant": n,
                    "same_bits_as": names[0], "same_bits": bool(torch.equal(results[n],
                                                                             results[names[0]])),
                    "ms": times[n], "ms_min": min(times[n]),
                    "ptxas": {k: info[n][k] for k in keys},
                    "sass_per_lane": {k: {c: v * _per_lane(n, k)
                                          for c, v in sass[n].get(k, {}).items()}
                                      for k in keys}}), flush=True)
            del runs, results


def run_ec_add(tmp: Path, rounds: int) -> None:
    sources = {YARDSTICK: (TOOLS / "ec_add_one_lane.cu").read_text()}
    names = {}
    for entry, (file, struct, changes) in EC_ADD_SETS.items():
        src = (kernels.CSRC / file).read_text()
        if len([m for m in LAUNCH_LINE.finditer(src) if m.group(1) == struct]) != 2:
            sys.exit(f"launch_variants: {file} no longer has the two {struct} lines this "
                     "script edits")
        names[entry] = [YARDSTICK]
        for label, ch in changes:
            text = ec_add_variant(src, struct, ch)
            if ch and text == src:
                continue                      # the committed lines already
            sources[f"{entry}.{label}"] = text
            names[entry].append(f"{entry}.{label}")
    logs = build(tmp, sources)
    for name, log in logs.items():
        (tmp / f"lib{name}.log").write_text(log)
        sass = sass_counts(tmp / f"lib{name}.so")
        (tmp / f"lib{name}.sass.json").write_text(json.dumps(sass))
        print(json.dumps({"set": "ec_add", "variant": name, "ptxas": kernels.parse_ptxas(log),
                          "sass_per_thread": sass}), flush=True)
    # one entry point at a time, each in processes of its own: a kernel of
    # one entry point never runs before another's in the same process
    for entry in EC_ADD_SETS:
        good = checked_variants(tmp, names[entry], entry)
        if not good:
            print(json.dumps({"set": "ec_add", "entry": entry, "no_variant_passed": True}))
            continue
        proc = _child(["--time", entry, "--names", ",".join(good), "--dir", str(tmp),
                       "--rounds", str(rounds)])
        out, _ = proc.communicate()
        print(out.strip(), flush=True)
        if proc.returncode != 0:
            print(json.dumps({"set": "ec_add", "entry": entry, "timing_failed": True}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("ec_wave_add", "ec_add"), default=None)
    ap.add_argument("--rounds", type=int, default=3)
    # child modes of run_ec_add
    ap.add_argument("--check", help=argparse.SUPPRESS)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--entry", help=argparse.SUPPRESS)
    ap.add_argument("--names", help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("launch_variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.check:
        check_variant(Path(args.dir), args.check, args.entry)
        return
    if args.time:
        time_entry(Path(args.dir), args.time, args.names.split(","), args.rounds)
        return
    with tempfile.TemporaryDirectory() as tmp:
        if args.only in (None, "ec_add"):
            run_ec_add(Path(tmp), args.rounds)
        if args.only in (None, "ec_wave_add"):
            run_k6(Path(tmp))
    print(smi_line(), flush=True)


if __name__ == "__main__":
    main()
