"""One proof by three party threads of one process on one card: the
program's `mpc.runner.run_parties` over its in-process network, each party's
network wrapped to count its rounds, party 0's spans on a tracer that ends
each span in a device synchronize (traced runs only), and the port's kernel
launches counted between the proof's start and its end alone."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .frozen import counting_net


@dataclass
class ProofRun:
    proofs: list                 # each party's result
    start: float                 # host clock at the start, after a synchronize
    end: float                   # host clock at the end, after a synchronize
    rounds: list                 # each party's rounds (messages to the next party)
    sent: list                   # each party's bytes sent (the benchmark's count)
    spans: dict = field(default_factory=dict)   # party 0's {span name: seconds}
    launches: dict = field(default_factory=dict)  # the port's launches, a kernel


def prove(party_fn, traced: bool, sync) -> ProofRun:
    """party_fn(i, net, tracer) -> party i's proof."""
    from cocircom_tpu_torch.mpc.runner import run_parties
    from cocircom_tpu_torch.ops.kernels import launch_counts
    from cocircom_tpu_torch.utils.trace import Tracer

    rounds, sent, rows = [0] * 3, [0] * 3, []

    def party(i, net):
        cnet = counting_net(net)
        tracer = Tracer(enabled=traced and i == 0, net=cnet, sync=sync)
        out = party_fn(i, cnet, tracer)
        rounds[i], sent[i] = cnet.rounds, cnet.sent
        if i == 0:
            rows.extend(tracer.rows)
        return out

    sync()
    before = launch_counts()
    t0 = time.perf_counter()
    proofs = run_parties(party, 3)
    sync()
    t1 = time.perf_counter()
    launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                if n != before.get(k, 0)}
    spans: dict = {}
    for _, name, dt, _, _ in rows:
        spans[name] = spans.get(name, 0.0) + dt
    return ProofRun(proofs, t0, t1, rounds, sent, spans, launches)
