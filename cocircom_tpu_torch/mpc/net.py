"""Party-to-party communication: the in-process backend.

``LocalNetwork`` is a queue mesh for N parties in one process (threads),
the deployment shape of "3 parties co-located on one card".  Payloads are
tensors, tuples of tensors or bytes and are handed over as they are (device
tensors stay on the device); byte counters are tracked per party.
"""

from __future__ import annotations

import queue
from typing import Any

import torch


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (bytes, bytearray, str)):
        return len(obj)
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(o) for o in obj)
    return 8


class Network:
    """Abstract N-party network; party ids 0..n-1."""

    id: int
    n_parties: int

    def send(self, to: int, obj: Any) -> None:
        raise NotImplementedError

    def recv(self, frm: int) -> Any:
        raise NotImplementedError

    # --- ring helpers (REP3 convention: next = (id+1) % n) ---

    @property
    def next_id(self) -> int:
        return (self.id + 1) % self.n_parties

    @property
    def prev_id(self) -> int:
        return (self.id - 1) % self.n_parties

    def send_next(self, obj) -> None:
        self.send(self.next_id, obj)

    def send_prev(self, obj) -> None:
        self.send(self.prev_id, obj)

    def recv_prev(self) -> Any:
        return self.recv(self.prev_id)

    def recv_next(self) -> Any:
        return self.recv(self.next_id)

    def broadcast(self, obj) -> list:
        """Send to all others, receive from all others; result[i] = party
        i's value (own slot holds obj)."""
        for to in range(self.n_parties):
            if to != self.id:
                self.send(to, obj)
        return [obj if frm == self.id else self.recv(frm) for frm in range(self.n_parties)]

    def broadcast_next(self, obj, num: int) -> list:
        """Send to the next num-1 parties on the ring and receive from the
        previous num-1: result[0] = own, result[k] = from (id-k) mod n."""
        for k in range(1, num):
            self.send((self.id + k) % self.n_parties, obj)
        return [obj] + [self.recv((self.id - k) % self.n_parties) for k in range(1, num)]


class LocalNetwork(Network):
    """In-process queue mesh (one object per party, shared queue table)."""

    RECV_TIMEOUT = 1800

    def __init__(self, pid: int, n: int, queues, counters):
        self.id = pid
        self.n_parties = n
        self._queues = queues
        self._counters = counters

    @classmethod
    def create(cls, n: int = 3) -> list["LocalNetwork"]:
        queues = {(i, j): queue.Queue() for i in range(n) for j in range(n) if i != j}
        counters = {"sent": [0] * n, "recv": [0] * n}
        return [cls(i, n, queues, counters) for i in range(n)]

    def send(self, to: int, obj: Any) -> None:
        self._counters["sent"][self.id] += _nbytes(obj)
        self._queues[(self.id, to)].put(obj)

    def ready(self, frm: int) -> bool:
        """True when a recv(frm) would not wait (each queue has one reader)."""
        return not self._queues[(frm, self.id)].empty()

    def recv(self, frm: int) -> Any:
        obj = self._queues[(frm, self.id)].get(timeout=self.RECV_TIMEOUT)
        self._counters["recv"][self.id] += _nbytes(obj)
        return obj

    def stats(self):
        """(bytes sent, bytes received) by this party so far."""
        return self._counters["sent"][self.id], self._counters["recv"][self.id]
