"""The numbers a cell's check compares, read on many seeds in one process:
the sound program's (the lower readings) or, with `--control`, the
control's (the upper readings), each run a short window at the cell's own
size.  The benchmark's own runs never run this.

    python3 -m cobench.readings --workload <name> --seeds 1,2,3 [--seconds 1] [--control]

Prints one JSON line a seed, {"seed", "correct", "checks", "proofs"}, and
one last line with every check's largest reading over the seeds.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import manifest
from .run import THREADS, forbidden_modules, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cobench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available():
        print("cobench.readings: no CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load_benchmark()
    cell = manifest.workload(bench, args.workload)
    most: dict = {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = run_cell(bench, cell, seed, args.seconds, False, "cuda", control=args.control,
                       warm_up=i == 0)
        vals = {k: c["value"] for k, c in res["checks"].items()}
        for k, v in vals.items():
            most[k] = max(most.get(k, v), v)
        print(json.dumps({"seed": seed, "control": args.control, "correct": res["correct"],
                          "checks": vals, "proofs": res["attempted"]}), flush=True)
        torch.cuda.empty_cache()
    if forbidden_modules():
        print(f"cobench.readings: loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    print(json.dumps({"workload": args.workload, "control": args.control, "largest": most}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
