"""In-process multi-party runner: N parties as threads + LocalNetwork.

Spawn N threads running the same function over a queue mesh, join, return
per-party results.  Exceptions propagate: the first one is re-raised as soon
as its party has stopped, without waiting for the peers it left at a
receive.  All threads launch on the current CUDA stream of their device, so
their kernels serialise on the card.

The parties also take turns on the host.  They share one lock, the compute
turn: a party holds it while it computes and gives it up only while it waits
at a receive, so one party's Python thread runs at a time.  The parties of a
symmetric protocol wait for each other at every round anyway, and three
threads that each issue thousands of small tensor ops otherwise spend their
time handing the interpreter lock back and forth.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from .net import LocalNetwork, Network


class _TurnNetwork(Network):
    """A party's network that gives up the compute turn while a receive
    waits.  Everything else is the wrapped network's."""

    def __init__(self, inner: LocalNetwork, turn: threading.Lock):
        self.id = inner.id
        self.n_parties = inner.n_parties
        self._inner = inner
        self._turn = turn

    def send(self, to: int, obj: Any) -> None:
        self._inner.send(to, obj)

    def recv(self, frm: int) -> Any:
        if self._inner.ready(frm):
            return self._inner.recv(frm)
        self._turn.release()
        try:
            return self._inner.recv(frm)
        finally:
            self._turn.acquire()

    def stats(self):
        return self._inner.stats()


def run_parties(fn: Callable, n: int = 3, timeout: float = 3600.0) -> list:
    """fn(party_id, net) -> result; returns [result_0, ..., result_{n-1}]."""
    turn = threading.Lock()
    nets = [_TurnNetwork(net, turn) for net in LocalNetwork.create(n)]
    results = [None] * n
    errors = [None] * n

    def work(i):
        with turn:
            try:
                results[i] = fn(i, nets[i])
            except BaseException as e:  # noqa: BLE001 — propagate to the caller
                errors[i] = e

    threads = [threading.Thread(target=work, args=(i,), name=f"party-{i}", daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    while any(t.is_alive() for t in threads) and not any(e is not None for e in errors):
        if time.monotonic() > deadline:
            raise TimeoutError("party thread did not finish")
        for t in threads:
            t.join(0.05)
    for e in errors:
        if e is not None:
            raise e
    return results
