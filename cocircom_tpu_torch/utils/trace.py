"""Per-phase wall-clock spans for the provers.

Spans nest.  Each finished span appends (depth, name, seconds, bytes sent,
bytes received) to `rows`; the byte counts are the deltas of the attached
network's `stats()`.  With `sync` set (e.g. `torch.cuda.synchronize`) a span
ends only when the device has finished its work, so it is device-inclusive
time and not enqueue time.  A disabled tracer costs one branch per span.
"""

from __future__ import annotations

import contextlib
import time


class Tracer:
    def __init__(self, enabled: bool = True, net=None, sync=None):
        self.enabled = enabled
        self.net = net
        # optional callable run at the end of every span before the clock
        # is read (e.g. torch.cuda.synchronize, so a span is device time)
        self.sync = sync
        self.rows: list[tuple[int, str, float, int, int]] = []
        self._depth = 0

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


_NULL = Tracer(enabled=False)


def tracer_or_null(t: "Tracer | None") -> Tracer:
    return t if t is not None else _NULL
