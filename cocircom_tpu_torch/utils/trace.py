"""Per-phase wall-clock spans for the provers, and leak gating.

Spans nest.  Each finished span appends (depth, name, seconds, bytes sent,
bytes received) to `rows`; the byte counts are the deltas of the attached
network's `stats()`.  With `sync` set (e.g. `torch.cuda.synchronize`) a span
ends only when the device has finished its work, so it is device-inclusive
time and not enqueue time.  A disabled tracer costs one branch per span.
``Tracer()`` with no `enabled` reads the ``COCIRCOM_TRACE`` switch, and
`report()` renders the rows, the process's kernel launch counts and its
peak device memory.

Any log line that could print secret-derived values is gated behind
``COCIRCOM_ALLOW_LEAKY_LOGS=1`` (the upstream `dangerous` feature,
mpc-core/Cargo.toml:14-16, traits.rs:198-207).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class Tracer:
    def __init__(self, enabled: bool | None = None, net=None, sync=None):
        if enabled is None:
            enabled = bool(os.environ.get("COCIRCOM_TRACE"))
        self.enabled = enabled
        self.net = net
        # optional callable run at the end of every span before the clock
        # is read (e.g. torch.cuda.synchronize, so a span is device time)
        self.sync = sync
        self.rows: list[tuple[int, str, float, int, int]] = []
        self._depth = 0
        # launch counts taken and reset before the traced work (report)
        self.setup_launches: dict | None = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        sent0, recvd0 = self.net.stats() if self.net else (0, 0)
        t0 = time.perf_counter()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - t0
            sent1, recvd1 = self.net.stats() if self.net else (0, 0)
            self.rows.append(
                (self._depth, name, dt, sent1 - sent0, recvd1 - recvd0))

    def report(self, out=None):
        """Print the span table, then one line `launches {json}` with the
        kernel launch counts that are not zero (since `setup_launches` was
        taken and the counts reset, where it was: that line comes first as
        `launches_setup {json}`) and, where CUDA was used, one line
        `peak_device_bytes N` (`torch.cuda.max_memory_allocated`)."""
        if not self.enabled:
            return
        out = sys.stderr if out is None else out
        if self.rows:
            width = max(len("  " * d + n) for d, n, *_ in self.rows) + 2
            print(f"{'phase':<{width}} {'wall':>9} {'sent':>12} {'recvd':>12}", file=out)
            for depth, name, dt, sent, recvd in self.rows:
                label = "  " * depth + name
                print(f"{label:<{width}} {dt * 1e3:8.1f}ms {sent:>11}B {recvd:>11}B",
                      file=out)
        import torch

        from ..ops.kernels import launch_counts

        if self.setup_launches is not None:
            print("launches_setup " + json.dumps({k: v for k, v in self.setup_launches.items()
                                                  if v}), file=out)
        print("launches " + json.dumps({k: v for k, v in launch_counts().items() if v}),
              file=out)
        if torch.cuda.is_initialized():
            print(f"peak_device_bytes {torch.cuda.max_memory_allocated()}", file=out)
        out.flush()


_NULL = Tracer(enabled=False)


def tracer_or_null(t: "Tracer | None") -> Tracer:
    return t if t is not None else _NULL


# ------------------------------------------------------------ leak gating

def leaky_logs_allowed() -> bool:
    """Opt-in gate for any log line that could contain secret-derived data."""
    return os.environ.get("COCIRCOM_ALLOW_LEAKY_LOGS") == "1"


def leak_guard(what: str):
    """Raise unless leaky output was explicitly enabled."""
    if not leaky_logs_allowed():
        raise PermissionError(
            f"{what} would reveal secret-derived values; set "
            "COCIRCOM_ALLOW_LEAKY_LOGS=1 to allow (the upstream 'dangerous' "
            "feature, mpc-core traits.rs:198-207)")
