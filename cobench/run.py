"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m cobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with the cell's CUDA cards.  The
run builds the cell's inputs from the seed and warms up with one proof of
the cell's own shapes (that, the CUDA context and, in a fresh checkout,
the kernels' nvcc build under `cocircom_tpu_torch/_build/` is `setup_s`),
then proves one proof at a time until the proofs' walls add up to
`--seconds`: the proof that crosses them finishes and counts, and each
proof's shares are dealt before its clock starts.  With `--trace 0` it reports
the cell's end-to-end metrics.  With `--trace 1` the window's proofs carry
party 0's spans (a device synchronize each) and the per-layer metrics are
read from them, from the launch counts and from one more proof, after the
window, under `torch.profiler` (the device's activity, the rooflines).
Then it checks every proof of the window against the plain reference
(`reference/`) and prints each number compared beside its limit, on
standard error and under `checks` in the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from . import manifest, parties, window  # noqa: E402

THREADS = 1                      # torch's intra-op threads: the parties take turns on the host
FORBIDDEN = ("jax", "jaxlib", "flax", "cocircom_tpu")


@dataclass
class Run:
    """What a per-layer metric's reader reads."""

    runs: list                   # the window's ProofRuns
    launches: dict               # the port's kernel launches in the window's proofs
    profile: object = None       # trace.DeviceProfile of the profiled proof
    bounds: dict | None = None   # {kernel: least seconds} of the profiled proof's launches


def power_limit_w() -> float | None:
    """The card's power limit as nvidia-smi reads it (a card set below its
    700 W runs slower under load), or None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0].split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
             control: bool = False, config: dict | None = None, warm_up: bool = True) -> dict:
    """One run of `cell`; returns the result's dict, `checks` last.  A test
    passes `config` in place of the cell's file (a smaller size) and a CPU
    device, and `readings` may leave out the warm-up in a process that
    already made one; the benchmark's own runs take the file, the card and
    the warm-up."""
    import torch

    from . import trace as tracing

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config = config or manifest.load_config(cell["config"])
    traffic = manifest.load_traffic(cell["traffic"])
    if traffic.get("loop") != "closed" or int(traffic.get("in_flight", 1)) != 1:
        raise ValueError("the harness drives closed-loop traffic, one proof in flight")
    prover = manifest.prover(config["prover"]).Cell(config, traffic, seed, device, control)

    if warm_up:
        parties.prove(prover.party_fn(prover.job("warm-up")), False, sync)
    setup_s = time.perf_counter() - T_START

    # proof k + 1's shares are dealt between proofs k and k + 1, off the
    # window's clock: no prover party does the dealer's work
    job = prover.job(0)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    runs, attempted, failed = [], 0, 0
    while True:
        attempted += 1
        try:
            runs.append(parties.prove(prover.party_fn(job), trace, sync))
        except Exception as e:  # noqa: BLE001 — a proof that fails is counted and ends the window
            print(f"cobench: proof {len(runs)} failed: {e!r}", file=sys.stderr)
            failed += 1
            break
        job = None
        if window.elapsed(runs) >= seconds:
            break
        job = prover.job(len(runs))
    print("cobench: proof walls " + " ".join(f"{r.end - r.start:.3f}" for r in runs) + " s",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches: dict = {}
    for r in runs:
        for c, n in r.launches.items():
            launches[c] = launches.get(c, 0) + n
    data = Run(runs, launches)
    if trace and runs:
        # one more proof under the profiler, after the window so that the
        # profiler's cost touches none of the window's spans; its launches'
        # shapes are recorded for the rooflines
        job = prover.job("profiled")
        recorder = tracing.LaunchRecorder()
        with recorder.recording():
            if cuda:
                _, data.profile = tracing.profile(
                    lambda: parties.prove(prover.party_fn(job), False, sync))
            else:
                parties.prove(prover.party_fn(job), False, sync)
        data.bounds = recorder.bound_seconds()

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if data.profile is not None:
        dev.update(busy_s=data.profile.busy_s, window_s=data.profile.window_s,
                   power_limit_w=power_limit_w())
        breakdown = tracing.breakdown(data.profile)

    metrics = {}
    if runs:
        e2e = window.end_to_end(runs, setup_s, peak)
        for m in manifest.metrics_for(bench, cell["name"], trace):
            value = e2e.get(m["name"]) if not trace else manifest.metric_reader(m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if runs:
        t0 = time.perf_counter()
        checks = prover.check(runs)
        print(f"cobench: {len(runs)} proofs in the window; the check took "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    else:
        checks = [("proofs_completed", 0, -1)]
    correct = failed == 0 and all(v <= limit for _, v, limit in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cobench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(THREADS)
    bench = manifest.load_benchmark()
    cell = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cobench: {args.workload} needs {cell['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2

    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")

    loaded = forbidden_modules()
    if loaded:
        print(f"cobench: the process loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
