"""Party-to-party communication backends.

  * ``LocalNetwork``: a queue mesh for N parties in one process (threads),
    the deployment shape of "3 parties co-located on one card".  Payloads
    are tensors, tuples of tensors or bytes and are handed over as they are
    (device tensors stay on the device).
  * ``TcpNetwork``: a full TCP mesh for parties in separate processes or on
    separate hosts, optionally under mutual TLS pinned to each party's
    certificate, with the JAX package's fixed-schema codec (mpc/codec.py) on
    4-byte length-delimited frames.  Tensors cross as numpy arrays and come
    back as tensors on the receiving network's device.

Byte counters are tracked per party; ``stats()`` gives (sent, received).
"""

from __future__ import annotations

import os
import queue
import socket
import ssl
import struct
import threading
import time
from typing import Any

import numpy as np
import torch

from ..ops.field import resolve_device
from .codec import decode as _decode
from .codec import encode as _encode


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


def _to_wire(obj):
    """Tensors -> numpy arrays, through tuples (NamedTuples become plain
    tuples), lists and dicts; wire-native values pass as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().contiguous().cpu().numpy()
    if isinstance(obj, tuple):
        return tuple(_to_wire(o) for o in obj)
    if isinstance(obj, list):
        return [_to_wire(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_wire(v) for k, v in obj.items()}
    return obj


def _from_wire(obj, device: torch.device):
    """numpy arrays -> tensors on `device`, through the same containers."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj).to(device)
    if isinstance(obj, tuple):
        return tuple(_from_wire(o, device) for o in obj)
    if isinstance(obj, list):
        return [_from_wire(o, device) for o in obj]
    if isinstance(obj, dict):
        return {k: _from_wire(v, device) for k, v in obj.items()}
    return obj


class TcpNetwork(Network):
    """Full-mesh TCP with 4-byte length-delimited frames and the fixed-schema
    codec (mpc/codec.py: no pickle, so a malicious peer's bytes can only
    decode to plain data).

    Connection setup mirrors mpc-net (lib.rs:45-171): party i accepts from
    parties j > i and connects to parties j < i; ids are exchanged on
    connect and checked against the expected direction (a connecting socket
    cannot claim an id that should have dialed us).  Each pair gets one
    socket; a reader thread per peer decodes frames into a per-peer queue
    (channel.rs:135-236).

    Mutual TLS (mpc-net/src/lib.rs:47-78): with ``tls=TlsConfig(...)`` every
    connection requires the exact pinned peer certificate (self-signed, made
    by `gen-cert`), and a claimed party id is bound to that party's own
    pinned certificate in both directions (mpc-net/src/config.rs:52-98): a
    holder of party 1's certificate cannot claim id 2.

    Tensors are sent as ``t.contiguous().cpu().numpy()``; what arrives is
    turned back into tensors on `device` (the card unless the caller names
    another) in ``recv``, in the calling party's thread, so every CUDA call
    stays on that party's thread and stream.  A NamedTuple arrives as a
    plain tuple; the drivers rebuild their types.  Both counters count whole
    frames, header included.  ``COCIRCOM_NET_LOG=<path>`` appends one line a
    send and a receive (a round-schedule trace)."""

    MAX_FRAME = 1 << 30
    RECV_TIMEOUT = 600

    def __init__(self, pid: int, addresses: list[tuple[str, int]], timeout: float = 60.0,
                 tls: "TlsConfig | None" = None, device=None):
        self.device = resolve_device(device)
        self.id = pid
        self.n_parties = len(addresses)
        self._socks: dict[int, socket.socket] = {}
        self._queues: dict[int, queue.Queue] = {}
        self._sent = 0
        self._recvd = 0
        self._lock = threading.Lock()
        self._tls = tls
        # opened once here: a check-then-act open in _netlog could race
        path = os.environ.get("COCIRCOM_NET_LOG")
        self._log = open(path, "a", buffering=1) if path else None
        try:
            self._connect_mesh(addresses, timeout)
        except BaseException:
            for s in list(self._socks.values()):
                s.close()
            if self._log is not None:
                self._log.close()
            raise
        self._readers = []
        for peer, s in self._socks.items():
            q = queue.Queue()
            self._queues[peer] = q
            t = threading.Thread(target=self._reader, args=(s, q), daemon=True,
                                 name=f"net-reader-{self.id}-{peer}")
            t.start()
            self._readers.append(t)

    def _wrap_tls(self, sock, server_side: bool):
        """Wrap a mesh socket in mutual TLS pinned to the party certs."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER if server_side else ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(self._tls.cert_path, self._tls.key_path)
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.check_hostname = False  # pinned self-signed certs, not PKI names
        for path in self._tls.party_cert_paths.values():
            ctx.load_verify_locations(path)
        return ctx.wrap_socket(sock, server_side=server_side)

    def _cert_matches_id(self, conn, claimed_id: int) -> bool:
        """True iff the TLS peer presented exactly the certificate pinned for
        `claimed_id` (True when TLS is off, False for an id with no pinned
        certificate)."""
        if self._tls is None:
            return True
        want = self._tls.der_for_id(claimed_id)
        if want is None:
            return False
        try:
            got = conn.getpeercert(binary_form=True)
        except (ssl.SSLError, OSError, AttributeError):
            return False
        return got == want

    def _connect_mesh(self, addresses, timeout):
        """Build the mesh within one deadline, `timeout` seconds from now.
        The accept thread stops at the deadline, whatever handshake it is
        in, and a connection it completes after the set-up has ended
        (`stop`) is closed, never left in `_socks`."""
        deadline = time.monotonic() + timeout
        host, port = addresses[self.id]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(self.n_parties)

        expected_in = [j for j in range(self.n_parties) if j > self.id]
        to_connect = [j for j in range(self.n_parties) if j < self.id]
        stop = threading.Event()
        socks_lock = threading.Lock()

        def left() -> float:
            return max(deadline - time.monotonic(), 0.001)

        def accept_all():
            pending = set(expected_in)
            while pending and not stop.is_set() and time.monotonic() < deadline:
                try:
                    srv.settimeout(left())
                    conn, _ = srv.accept()
                except OSError:  # timed out, or closed when the set-up ended
                    return
                try:
                    conn.settimeout(left())  # a silent peer cannot outlast the deadline
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    if self._tls:
                        conn = self._wrap_tls(conn, True)
                    peer = struct.unpack("<I", self._recv_exact(conn, 4))[0]
                except (ssl.SSLError, ConnectionError, OSError):
                    # a failed handshake (no pinned certificate) or a peer
                    # that hung up: refuse it and keep accepting
                    conn.close()
                    continue
                if peer not in pending or not self._cert_matches_id(conn, peer):
                    # a wrong direction, a duplicate claim, or an id not
                    # backed by that party's pinned certificate: refuse
                    conn.close()
                    continue
                with socks_lock:
                    if stop.is_set():
                        conn.close()
                        return
                    pending.discard(peer)
                    self._socks[peer] = conn

        acc = threading.Thread(target=accept_all, daemon=True, name=f"net-accept-{self.id}")
        acc.start()
        try:
            for j in to_connect:
                while True:
                    try:
                        s = socket.create_connection(addresses[j], timeout=left())
                        break
                    except OSError:
                        if time.monotonic() >= deadline:
                            raise
                        time.sleep(0.05)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if self._tls:
                    s = self._wrap_tls(s, False)
                    if not self._cert_matches_id(s, j):
                        s.close()
                        raise ConnectionError(f"party {j} presented a certificate that is "
                                              f"not the one pinned for id {j}")
                s.sendall(struct.pack("<I", self.id))
                with socks_lock:
                    self._socks[j] = s
            acc.join(left())
        finally:
            with socks_lock:
                stop.set()
            srv.close()
        if len(self._socks) != self.n_parties - 1:
            raise ConnectionError(
                f"mesh incomplete: {sorted(self._socks)} of {self.n_parties - 1} peers")
        # the handshake timeout must not outlive the handshake: a reader on a
        # socket that keeps it would take a long gap between rounds (a peer
        # reading a large zkey) for a closed peer.  Liveness is the recv
        # queue's timeout instead.
        for s in self._socks.values():
            s.settimeout(None)

    @staticmethod
    def _recv_exact(sock, n) -> bytes:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = sock.recv_into(view[got:], n - got)
            if not k:
                raise ConnectionError("peer closed")
            got += k
        return bytes(buf)

    def _reader(self, sock, q):
        try:
            while True:
                (ln,) = struct.unpack("<I", self._recv_exact(sock, 4))
                if ln > self.MAX_FRAME:
                    raise ValueError("frame too large")
                q.put((4 + ln, _decode(self._recv_exact(sock, ln))))
        except (ConnectionError, OSError):
            q.put((0, ConnectionError("peer closed")))
        except ValueError as e:  # a malformed frame from a bad peer
            q.put((0, ConnectionError(f"bad frame: {e}")))

    def _netlog(self, line: str) -> None:
        if self._log is not None:
            self._log.write(line + "\n")

    def send(self, to: int, obj: Any) -> None:
        payload = _encode(_to_wire(obj))
        if len(payload) > self.MAX_FRAME:
            raise ValueError(f"message of {len(payload)} bytes exceeds the "
                             f"{self.MAX_FRAME}-byte frame cap")
        frame = struct.pack("<I", len(payload)) + payload
        with self._lock:
            self._sent += len(frame)
        self._netlog(f"send to={to} n={len(payload)}")
        self._socks[to].sendall(frame)

    def recv(self, frm: int) -> Any:
        self._netlog(f"recv frm={frm}")
        n, obj = self._queues[frm].get(timeout=self.RECV_TIMEOUT)
        if isinstance(obj, ConnectionError):
            raise obj
        with self._lock:
            self._recvd += n
        return _from_wire(obj, self.device)

    def stats(self):
        """(bytes sent, bytes received) by this party so far."""
        with self._lock:
            return self._sent, self._recvd

    def close(self, linger: float = 10.0):
        """Graceful teardown: half-close (FIN) every connection, then give the
        reader threads up to `linger` seconds to drain the peers' in-flight
        frames and see their FIN, so a party that finishes first cannot pull
        data out from under slower peers.  A TLS connection is half-closed
        on its TCP socket too (the peer's reader sees an EOF after the last
        record): closing an SSL socket does not wake a reader blocked on it,
        so each reader would wait out `linger`."""
        for s in self._socks.values():
            try:
                # socket.socket.shutdown: SSLSocket.shutdown would drop the
                # TLS state under a reader still reading from it
                socket.socket.shutdown(s, socket.SHUT_WR)
            except OSError:
                pass
        for t in self._readers:
            t.join(timeout=linger)
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        if self._log is not None:
            self._log.close()
            self._log = None


class TlsConfig:
    """Mutual-TLS material for one party: its own key and certificate and
    every party's pinned certificate (mpc-net/src/config.rs:64-98).

    `party_cert_paths` (a dict or a list by party id) is the trust store,
    and it binds each claimed id to that party's own certificate
    (TcpNetwork._cert_matches_id)."""

    def __init__(self, key_path: str, cert_path: str,
                 party_cert_paths: dict[int, str] | list[str]):
        self.key_path = key_path
        self.cert_path = cert_path
        if isinstance(party_cert_paths, dict):
            self.party_cert_paths = {int(k): v for k, v in party_cert_paths.items()}
        else:
            self.party_cert_paths = dict(enumerate(party_cert_paths))
        self._der_cache: dict[int, bytes] = {}

    def der_for_id(self, party_id: int) -> bytes | None:
        """DER bytes of the certificate pinned for `party_id` (None if unmapped)."""
        path = self.party_cert_paths.get(party_id)
        if path is None:
            return None
        if party_id not in self._der_cache:
            with open(path) as fh:
                self._der_cache[party_id] = ssl.PEM_cert_to_DER_cert(fh.read())
        return self._der_cache[party_id]


def gen_self_signed_cert(key_out: str, cert_out: str, dns_name: str = "localhost",
                         days: int = 365) -> None:
    """Write a fresh self-signed certificate and its private key (PEM),
    with the `cryptography` package (mpc-net/src/bin/gen_cert.rs:21-31).
    Raises ImportError naming the package where it is not installed."""
    import datetime
    import secrets

    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError as e:
        raise ImportError(f"gen-cert needs the 'cryptography' package: {e}") from e

    key = ec.generate_private_key(ec.SECP256R1())
    # a unique subject per certificate: OpenSSL looks trust-store roots up
    # by subject, and self-signed party certificates sharing one CN collide
    # (the mesh loads every peer into one store)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         f"{dns_name}-{secrets.token_hex(8)}")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName([x509.DNSName(dns_name)]), critical=False)
        .sign(key, hashes.SHA256())
    )
    with open(key_out, "wb") as fh:
        fh.write(key.private_bytes(serialization.Encoding.PEM,
                                   serialization.PrivateFormat.PKCS8,
                                   serialization.NoEncryption()))
    with open(cert_out, "wb") as fh:
        fh.write(cert.public_bytes(serialization.Encoding.PEM))
