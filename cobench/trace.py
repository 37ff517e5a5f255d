"""What a traced run records beyond spans and counters: the shapes of the
port's kernel launches (for the rooflines) and the device's activity under
`torch.profiler` over one whole proof.

`LaunchRecorder` wraps the kernel entry points of `ops/kernels.py` for as
long as it is open and keeps, a launch, what the work counts need: the
shapes, and for `ec_madd` a reference to its run-bound tables, whose valid
lanes are counted once the proof has ended (so the proof runs no extra
device work).  Only the traced run opens one.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field

from . import roofline

# the CUDA kernels' own names, as the profiler reports them
KERNEL_NAMES = {"mont_mul": "mont_mul_kernel", "ntt_columns": "ntt_columns_kernel",
                "ec_madd": "ec_madd_kernel"}


class LaunchRecorder:
    def __init__(self):
        self.records: dict = {k: [] for k in KERNEL_NAMES}

    @contextlib.contextmanager
    def recording(self):
        from cocircom_tpu_torch.ops import kernels

        orig = {k: getattr(kernels, k) for k in KERNEL_NAMES}
        rec = self.records

        def mont_mul(a, b, consts):
            out = orig["mont_mul"](a, b, consts)
            L = out.shape[0]
            n = out.numel() // L
            rec["mont_mul"].append((L, n, a.numel() == L and n != 1, b.numel() == L and n != 1))
            return out

        def ntt_columns(x, tw, consts, post=None, transpose=False):
            out = orig["ntt_columns"](x, tw, consts, post, transpose)
            L, M, cols = x.shape
            V = post.shape[2] if post is not None else 1
            rec["ntt_columns"].append((L, M, cols, V, post is not None))
            return out

        def ec_madd(acc, table, astart, aend, w, consts):
            out = orig["ec_madd"](acc, table, astart, aend, w, consts)
            L, nw, kp1, T = acc[0].shape
            rec["ec_madd"].append((L, nw, kp1, T, w, astart, aend))
            return out

        for k, fn in (("mont_mul", mont_mul), ("ntt_columns", ntt_columns),
                      ("ec_madd", ec_madd)):
            setattr(kernels, k, fn)
        try:
            yield self
        finally:
            for k, fn in orig.items():
                setattr(kernels, k, fn)

    def bound_seconds(self) -> dict:
        """{kernel: the sum of its launches' least times}; the ec_madd
        tables are read here and then released."""
        out = {}
        out["mont_mul"] = sum(roofline.bound_s(*roofline.mont_mul_work(*r))
                              for r in self.records["mont_mul"])
        out["ntt_columns"] = sum(roofline.bound_s(*roofline.ntt_columns_work(*r))
                                 for r in self.records["ntt_columns"])
        total = 0.0
        for L, nw, kp1, T, w, astart, aend in self.records["ec_madd"]:
            # lane (window, b, r) adds where b > 0 and astart + w T + r < aend
            left = (aend[:, 1:] - astart[:, 1:] - w * T).clamp(0, T)
            total += roofline.bound_s(*roofline.ec_madd_work(L, nw, kp1, int(left.sum())))
        out["ec_madd"] = total
        self.records["ec_madd"] = []
        return out


@dataclass
class DeviceProfile:
    """The device's activity over one traced proof."""

    window_s: float                      # host wall of the proof, ending in a synchronize
    busy_s: float                        # union of the device's operation intervals
    ops: int                             # device operations (kernels, copies, sets)
    by_name: dict = field(default_factory=dict)     # {name: device seconds}
    gaps: list = field(default_factory=list)        # [(label, seconds)], longest first

    def kernel_seconds(self, kernel: str) -> float:
        return sum(s for name, s in self.by_name.items() if KERNEL_NAMES[kernel] in name)


def _intervals(prof) -> list:
    """[(start_ns, end_ns, name)] of every device-side event of `prof`."""
    from torch.autograd import DeviceType

    cuda, out = DeviceType.CUDA, []
    append = out.append
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start = e.start_ns()
            append((start, start + e.duration_ns(), e.name()))
    return out


def profile(fn) -> tuple:
    """Run fn() under torch.profiler with device activity only; returns
    (fn's result, DeviceProfile)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    t_in = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = _intervals(prof)
    t2 = time.perf_counter()
    summary = summarize(events, wall)
    print(f"cobench: profiler start {t0 - t_in:.1f} s, profiled proof {wall:.1f} s, stop "
          f"{t1 - t0 - wall:.1f} s, {len(events)} device events read in {t2 - t1:.1f} s, "
          f"reduced in {time.perf_counter() - t2:.1f} s", file=sys.stderr)
    return result, summary


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("<")[0].split("(")[0].strip()[:80] or "?"


def summarize(events: list, wall: float) -> DeviceProfile:
    """Busy time as the union of the intervals, device time by name, and
    the idle gaps between operations, each named by the operation that
    ends it (what the host had to issue before the card could go on)."""
    events = sorted(events)
    busy_ns, by_name, gaps = 0, {}, []
    cur_s = cur_e = None
    for s, e, name in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
                gaps.append((s - cur_e, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    by_gap: dict = {}
    for ns, name in gaps:
        key = "before " + short_name(name)
        by_gap[key] = by_gap.get(key, 0.0) + ns / 1e9
    top_gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])
    return DeviceProfile(window_s=wall, busy_s=busy_ns / 1e9, ops=len(events),
                         by_name=by_name, gaps=top_gaps)


def breakdown(p: DeviceProfile) -> dict:
    """The result line's `breakdown`: the ten operations that took most
    device time and the ten largest idle sums, each [name, seconds]."""
    ops: dict = {}
    for name, s in p.by_name.items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in p.gaps[:10]]}
