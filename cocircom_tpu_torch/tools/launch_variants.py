#!/usr/bin/env python3
"""Time launch-shape and design variants of the curve kernels on one GPU.

Run from the repository root on a machine with an NVIDIA card and nvcc:

    python3 -m cocircom_tpu_torch.tools.launch_variants            # every set
    python3 -m cocircom_tpu_torch.tools.launch_variants --only ec_add
    python3 -m cocircom_tpu_torch.tools.launch_variants --only ec_wave_add
    python3 -m cocircom_tpu_torch.tools.launch_variants --only ec_madd

Each set builds copies of committed sources with the package's own nvcc
flags, each copy with named changes to the one-line launch specialisations
at the top of its source (`committed` for none), all copies of a set in
parallel, plus the yardstick: the one-lane-a-thread design the committed
kernels replaced (tools/ec_add_one_lane.cu: the 64-bit CIOS product).

  ec_add       the cooperative kernels: K4 `ec_add` (csrc/ec_add.cu), with
               its team fixed at 1 or 3 threads a lane, other block sizes and
               register caps, at its reduction shape (L, 22, 2048) and at 1,
               2, 1,024, 1,408, 2,048, 4,096, 8,192 and 11,264 lanes (where
               the launcher switches team); `ec_add_g2` (csrc/ec_add_g2.cu)
               at (L, 22, 2049, 8) and 1-2 lanes; `ec_wave_add_g2`
               (csrc/ec_wave_add_g2.cu) at (L, 22, 2049, 8), 80% valid.
  ec_wave_add  K6 (csrc/ec_wave_add.cu): block sizes and register caps.
  ec_madd      K5 (csrc/ec_madd.cu): block sizes and register caps.
               K5 and K6 are timed on the engine's own prepare of one
               2^17-point chunk of a c = 12 MSM ((L, 22, 2049, 8) lanes):
               its first wave alone, and every wave of the chunk in turn.
               Beside them two yardsticks: the old kernel alone, on rows
               the wave's gather wrote beforehand (`one_lane`), and the old
               whole wave, its PyTorch glue, the row gather and the old
               kernel (`one_lane+glue`); every timing is a CUDA graph, so
               `one_lane+glue` against `committed` is what reading the rows
               in the kernel bought on the card.

Both limb counts (8: BN254, 12: BLS12-381).  Every variant runs on the same
inputs.  A set runs one entry point at a time, each in processes of its
own: first every variant alone (a fault takes down only its process; a
variant that faults, or whose bits differ from those most variants give, is
reported and not timed), then all that passed in one process, in turns.
The script prints one JSON line per variant, limb count and shape:
milliseconds per run (a CUDA graph of runs timed with CUDA events; the
variants take turns, three rounds), the kernel launches a run holds, and per
kernel instantiation the registers, stack and spill bytes `ptxas` reports
and, where the toolkit has `cuobjdump`, the static count of IMAD* and of
IADD3/IADD instructions (per thread, and per lane: times the threads that
serve a lane).  Then the card's name and power limit.  Without a card it
exits 2.
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

# ---- {entry point: (source, launch struct, variants)}; a variant is a name
# and changes to the fields of the launch lines of both limb counts (none:
# the source as committed)
SETS = {
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
    "ec_wave_add": ("ec_wave_add.cu", "WaveLaunch", [
        ("committed", {}), ("t128", {"threads": 128, "min_blocks": 1}),
        ("t64", {"threads": 64, "min_blocks": 1}), ("t256", {"threads": 256, "min_blocks": 1}),
        ("t128_b3", {"threads": 128, "min_blocks": 3}),
        ("t128_b4", {"threads": 128, "min_blocks": 4}),
        ("t64_b8", {"threads": 64, "min_blocks": 8})]),
    "ec_madd": ("ec_madd.cu", "MaddLaunch", [
        ("committed", {}), ("t64", {"threads": 64, "min_blocks": 1}),
        ("t256", {"threads": 256, "min_blocks": 1}),
        ("t128_b3", {"threads": 128, "min_blocks": 3}),
        ("t128_b4", {"threads": 128, "min_blocks": 4})]),
}
# the --only choices: sets of entry points
GROUPS = {"ec_add": ("ec_add", "ec_add_g2", "ec_wave_add_g2"), "ec_wave_add": ("ec_wave_add",),
          "ec_madd": ("ec_madd",)}
LAUNCH_LINE = re.compile(r"template <> struct (\w+)<(8|12)> \{ static constexpr int ([^;]*); \};")
YARDSTICK = "one_lane"
# the old whole wave: its PyTorch glue, the row gather and the old kernel
# (the yardstick's library); only for the whole-wave entry points
GLUE = "one_lane+glue"
WHOLE_WAVE = ("ec_wave_add", "ec_madd")
# the yardstick's entry points of these kernels take rows, not the prepare
OLD_ARGTYPES = {
    # x y z (updated in place), rows, valid, n
    "ec_madd": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + kernels._TAIL,
    # x y z (updated in place), rows, neg, valid, n
    "ec_wave_add": [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + kernels._TAIL,
}


def lib_name(name: str) -> str:
    """The library a variant runs: the yardstick's for both yardsticks."""
    return YARDSTICK if name.startswith(YARDSTICK) else name


def edit_launch_lines(src: str, struct: str, changes: dict) -> str:
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


def load(tmp: Path, variant_name: str, name: str):
    """Entry point cc_<name> of a variant's library."""
    lib = lib_name(variant_name)
    fn = getattr(ctypes.CDLL(str(tmp / f"lib{lib}.so")), f"cc_{name}")
    old = lib == YARDSTICK and name in OLD_ARGTYPES
    fn.argtypes = OLD_ARGTYPES[name] if old else kernels._ARGTYPES[name]
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


# ----------------------------------------------------------------- cases

def cases(curve, entry: str) -> dict:
    """{shape name: make} for one entry point over one curve; make(fn,
    name) builds a launcher from variant `name`'s entry point and returns
    (run, result, kernel launches a run).  Each shape's inputs come from a
    generator of its own, so any process builds the same ones."""
    from ..ops.curve import add_wave_lanes, g1_ops, g2_ops, madd_wave_rows
    from ..ops.field import get_field
    from ..ops.msm import MSM

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
            return run, lambda: torch.stack(outs).clone(), 1
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
            return run, lambda: torch.stack(outs).clone(), 1
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
            return run, result, 1
        return make

    chunks = {}

    def chunk(kind):
        """The engine's prepare of one 2^17-point chunk of a c = 12 MSM over
        random scalars, and random coordinates: ("add", pts_em, order,
        sortedb, digits, bucket_start, waves) or ("madd", table, astart,
        aend, waves)."""
        if kind not in chunks:
            gen = torch.Generator().manual_seed(30)
            npt, nbits = 1 << 17, curve.fr.bits
            fr = get_field(curve.fr.p, curve.name + ".fr", "cuda")
            eng = MSM(g1, c=12, t=8, scalar_bits=nbits)
            scal = rand_elems(fr, npt, gen)
            if kind == "add":
                digits, order, sortedb, bstart, n_waves = eng._prepare(scal, nbits, 12)
                pts_em = torch.cat([rand_elems(f, npt, gen) for _ in range(3)]).t().contiguous()
                data = (pts_em, order, sortedb, digits, bstart)
            else:
                scatter_idx, astart, aend, n_waves = eng._prepare_madd(scal, nbits, 12)
                rows2 = torch.cat([rand_elems(f, 2 * npt, gen) for _ in range(2)]).t().contiguous()
                data = (eng._table_rows(rows2, scatter_idx), astart, aend)
            chunks[kind] = (data, -(-int(n_waves.item()) // 8))
        return chunks[kind]

    def whole_wave_case(kind, every_wave):
        """The first wave of the chunk, or every wave in turn, into one
        accumulator.  The committed kernel takes the prepare; the yardstick
        takes rows gathered before the run; `one_lane+glue` gathers them in
        the run, as the old wave step did."""
        def make(fn, name):
            data, n_super = chunk(kind)
            waves = range(n_super) if every_wave else range(1)
            bounds = data[-1]
            nw, kp1 = bounds.shape
            nl = nw * kp1 * 8
            gen = torch.Generator().manual_seed(31)
            work = [rand_elems(f, nl, gen) for _ in range(3)]
            acc = [t.data_ptr() for t in work]
            tail = (L, ctypes.addressof(g1._kconsts))

            def gathered(w):
                """(rows, masks) of wave w as the old wave step made them."""
                if kind == "add":
                    src, neg, valid = add_wave_lanes(*data[1:], w, 8)
                    return data[0].index_select(0, src), (neg, valid)
                rows, valid = madd_wave_rows(*data, w, 8)
                return rows, (valid,)

            def old(rows, masks):
                _checked(fn, name, *acc, rows.data_ptr(), *(m.data_ptr() for m in masks), nl,
                         *tail, _stream())

            if name == YARDSTICK:
                pre = [gathered(w) for w in waves]

                def run():
                    for rows, masks in pre:
                        old(rows, masks)
            elif name == GLUE:
                def run():
                    for w in waves:
                        old(*gathered(w))
            elif kind == "add":
                def run():
                    for w in waves:
                        _checked(fn, name, *acc, *(t.data_ptr() for t in data), 1 << 17, nw, kp1,
                                 8, w * 8, *tail, _stream())
            else:
                m_tab = data[0].shape[0] // nw

                def run():
                    for w in waves:
                        _checked(fn, name, *acc, *(t.data_ptr() for t in data), m_tab, nw, kp1, 8,
                                 w * 8, *tail, _stream())
            once = {}

            def result():
                # the first run's result: in-place updates accumulate
                if "res" not in once:
                    once["res"] = torch.stack(work).clone()
                return once["res"]
            return run, result, len(waves)
        return make

    if entry in WHOLE_WAVE:
        kind = "add" if entry == "ec_wave_add" else "madd"
        return {f"{entry}_l{L}_(22,2049,8)_first_wave": whole_wave_case(kind, False),
                f"{entry}_l{L}_(22,2049,8)_every_wave_of_a_chunk": whole_wave_case(kind, True)}
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
        for shape, make in cases(curve, entry).items():
            print(json.dumps({"launching": shape}), flush=True)
            run, result, _ = make(load(tmp, name, entry), name)
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
                print(json.dumps({"entry": entry, "variant": n, "check_failed": True,
                                  "output": out[-2500:]}), flush=True)
    if not digests:
        return []
    keys = [json.dumps(d, sort_keys=True) for d in digests.values()]
    want = json.loads(max(set(keys), key=keys.count))
    good = []
    for n, d in digests.items():
        if d == want:
            good.append(n)
        else:
            print(json.dumps({"entry": entry, "variant": n, "check_failed": True,
                              "differs_at": [k for k in d if d[k] != want.get(k)]}), flush=True)
    return good


def _per_lane(name: str, key: str) -> int:
    """Threads that serve a lane in kernel instantiation `key` of `name`."""
    if lib_name(name) == YARDSTICK:
        return 1
    m = re.search(r"_s(\d+)$", key)
    if m:
        return int(m.group(1))          # K4's team
    return 2 if "_g2_" in key else 1    # a pair a lane over Fq2


def time_entry(tmp: Path, entry: str, names: list, rounds: int) -> None:
    """Child process: the variants `names` of one entry point take turns at
    each of its shapes; one line per variant and shape."""
    info = {n: kernels.parse_ptxas((tmp / f"lib{lib_name(n)}.log").read_text()) for n in names}
    sass = {n: json.loads((tmp / f"lib{lib_name(n)}.sass.json").read_text()) for n in names}
    for curve in (BN254, BLS12_381):
        for shape, make in cases(curve, entry).items():
            L = 8 if "_l8_" in shape else 12
            runs = {n: make(load(tmp, n, entry), n) for n in names}
            results, times = {}, {n: [] for n in names}
            for n, (run, result, _) in runs.items():
                run()
                torch.cuda.synchronize()
                results[n] = result()
            reps = 20 if "(22," in shape else 200
            for _ in range(rounds):
                for n, (run, _, _) in runs.items():
                    times[n].append(time_graph(run, reps))
            for n in names:
                keys = [k for k in info[n]
                        if k == f"{entry}_l{L}" or k.startswith(f"{entry}_l{L}_s")]
                print(json.dumps({
                    "entry": entry, "shape": shape, "variant": n,
                    "same_bits_as": names[0], "same_bits": bool(torch.equal(results[n],
                                                                             results[names[0]])),
                    "launches_per_run": runs[n][2], "ms": times[n], "ms_min": min(times[n]),
                    "ptxas": {k: info[n][k] for k in keys},
                    "sass_per_lane": {k: {c: v * _per_lane(n, k)
                                          for c, v in sass[n].get(k, {}).items()}
                                      for k in keys}}), flush=True)
            del runs, results


def run_sets(tmp: Path, entries, rounds: int) -> None:
    sources = {YARDSTICK: (TOOLS / "ec_add_one_lane.cu").read_text()}
    names = {}
    for entry in entries:
        file, struct, changes = SETS[entry]
        src = (kernels.CSRC / file).read_text()
        if len([m for m in LAUNCH_LINE.finditer(src) if m.group(1) == struct]) != 2:
            sys.exit(f"launch_variants: {file} no longer has the two {struct} lines this "
                     "script edits")
        names[entry] = [YARDSTICK] + ([GLUE] if entry in WHOLE_WAVE else [])
        for label, ch in changes:
            text = edit_launch_lines(src, struct, ch)
            if ch and text == src:
                continue                      # the committed lines already
            sources[f"{entry}.{label}"] = text
            names[entry].append(f"{entry}.{label}")
    logs = build(tmp, sources)
    for name, log in logs.items():
        (tmp / f"lib{name}.log").write_text(log)
        sass = sass_counts(tmp / f"lib{name}.so")
        (tmp / f"lib{name}.sass.json").write_text(json.dumps(sass))
        print(json.dumps({"variant": name, "ptxas": kernels.parse_ptxas(log),
                          "sass_per_thread": sass}), flush=True)
    # one entry point at a time, each in processes of its own: a kernel of
    # one entry point never runs before another's in the same process
    for entry in entries:
        good = checked_variants(tmp, names[entry], entry)
        if not good:
            print(json.dumps({"entry": entry, "no_variant_passed": True}))
            continue
        proc = _child(["--time", entry, "--names", ",".join(good), "--dir", str(tmp),
                       "--rounds", str(rounds)])
        out, _ = proc.communicate()
        print(out.strip(), flush=True)
        if proc.returncode != 0:
            print(json.dumps({"entry": entry, "timing_failed": True}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=tuple(GROUPS), default=None)
    ap.add_argument("--rounds", type=int, default=3)
    # child modes of run_sets
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
    entries = GROUPS[args.only] if args.only else tuple(SETS)
    with tempfile.TemporaryDirectory() as tmp:
        run_sets(Path(tmp), entries, args.rounds)
    print(smi_line(), flush=True)


if __name__ == "__main__":
    main()
