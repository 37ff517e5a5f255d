"""The share of one profiled proof's wall in which the card ran no
operation, in percent: 100 (1 - busy / wall), busy the union of the
profiler's device intervals."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
