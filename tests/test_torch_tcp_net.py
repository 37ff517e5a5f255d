"""Port vs JAX package: the wire codec and the TCP/TLS mesh (mpc/codec.py,
mpc/net.py).

The port's codec puts the JAX package's bytes on the wire for the same numpy
objects.  Over a `TcpNetwork` on localhost (three party threads, device
"cpu") tensors arrive as tensors of the same dtype and values, and with
every PRF seed pinned the REP3 and Shamir operations and the REP3 -> Shamir
bridge give share components bit-equal to the same program over the
in-process `LocalNetwork` (tolerance 0), so every receive site rebuilds what
crosses the wire as a plain tuple.  The drivers' cases come first.
"""

import socket
import ssl
import threading
import time

import numpy as np
import pytest
import torch

import cocircom_tpu_torch.mpc.rep3 as port_rep3
import cocircom_tpu_torch.utils.chacha as port_chacha
from cocircom_tpu.mpc import codec as ref_codec
from cocircom_tpu_torch.fields.ec_host import ec_add, ec_mul
from cocircom_tpu_torch.fields.params import BN254
from cocircom_tpu_torch.mpc import codec
from cocircom_tpu_torch.mpc.bridges import translate_rep3_to_shamir
from cocircom_tpu_torch.mpc.net import TcpNetwork, TlsConfig, gen_self_signed_cert
from cocircom_tpu_torch.mpc.rep3 import Rep3Driver, Rep3FieldShare, share_field_vec
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.mpc.shamir import (
    ShamirDriver,
    combine_field_shares_shamir,
    share_field_vec_shamir,
)
from cocircom_tpu_torch.ops.curve import ProjPoint, leaves
from cocircom_tpu_torch.ops.field import get_field
from chip_smoke import free_ports
from torch_port_util import pin_rep3_seeds, rand_ints, run_named, run_tcp

FR = get_field(BN254.fr.p, "bn254.fr", device="cpu")
N = 37


def _ints(limbs) -> list:
    return [int(v) for v in FR.from_limbs(FR.from_mont(limbs))]


def _both_networks(monkeypatch, party):
    """party(i, net) over the TCP mesh and over LocalNetwork, seeds pinned."""
    pin_rep3_seeds(monkeypatch, port_rep3, port_chacha)
    return run_tcp(party), run_named(run_parties, party)


def _assert_bit_equal(tcp, local):
    for got, want in zip(tcp, local):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            la, lb = leaves(a), leaves(b)
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                assert x.device.type == "cpu" and x.dtype == y.dtype and torch.equal(x, y)


def test_rep3_ops_equal_over_tcp_and_local(monkeypatch):
    """mul_vec, open, mul_open_many, a2b and unsigned_ge on 37 elements."""
    x, y = rand_ints(FR.p, N, 301), rand_ints(FR.p, N, 302)
    x[:3], y[:3] = [0, FR.p - 1, 5], [0, 1, 5]
    xs = share_field_vec(FR, FR.encode(x), seed=303)
    ys = share_field_vec(FR, FR.encode(y), seed=304)

    def party(i, net):
        d = Rep3Driver(BN254, net, device="cpu")
        z = d.mul_vec(xs[i], ys[i])
        opened = d.open(z)
        mo = d.mul_open_many(xs[i], ys[i])
        b = d.binary
        bx = b.a2b(xs[i])
        ge = b.unsigned_ge(xs[i], ys[i])
        return [z, opened, mo, bx, ge, b.open(bx), b.open(ge)]

    tcp, local = _both_networks(monkeypatch, party)
    _assert_bit_equal(tcp, local)
    want = [a * b % FR.p for a, b in zip(x, y)]
    for z, opened, mo, bx, ge, bx_open, ge_open in tcp:
        assert isinstance(z, Rep3FieldShare) and _ints(opened) == want == _ints(mo)
        assert [int(v) for v in FR.from_limbs(bx_open)] == x
        assert [int(v) for v in FR.from_limbs(ge_open)] == [int(a >= b) for a, b in zip(x, y)]


def test_shamir_ops_equal_over_tcp_and_local(monkeypatch):
    """mul_vec and open on 37 elements, and one open_point of a degree-1
    sharing P + (i + 1) Q of a G1 point."""
    x, y = rand_ints(FR.p, N, 311), rand_ints(FR.p, N, 312)
    xs = share_field_vec_shamir(FR, FR.encode(x), 1, 3, seed=313, device="cpu")
    ys = share_field_vec_shamir(FR, FR.encode(y), 1, 3, seed=314, device="cpu")
    gen = (BN254.g1_gen[0], BN254.g1_gen[1])
    from cocircom_tpu_torch.pairing.tower import Fp

    g = (Fp(gen[0], BN254.fq.p), Fp(gen[1], BN254.fq.p))
    P, Q = ec_mul(g, 1234567), ec_mul(g, 7654321)
    pt_shares = [ec_add(P, ec_mul(Q, i + 1)) for i in range(3)]

    def party(i, net):
        d = ShamirDriver(BN254, net, 1, device="cpu")
        z = d.mul_vec(xs[i], ys[i])
        opened = d.open(z)
        share = d.g1.encode_points([(pt_shares[i][0].v, pt_shares[i][1].v)])
        return [z, d.open(z), d.open_point(d.g1, share)]

    tcp, local = _both_networks(monkeypatch, party)
    _assert_bit_equal(tcp, local)
    want = [a * b % FR.p for a, b in zip(x, y)]
    fq, q = get_field(BN254.fq.p, "bn254.fq", device="cpu"), BN254.fq.p
    for z, opened, point in tcp:
        assert isinstance(point, ProjPoint) and _ints(opened) == want
        # homogeneous (X, Y, Z) -> affine on the host
        px, py, pz = (int(fq.decode(c.reshape(-1, 1))[0]) for c in point)
        zi = pow(pz, -1, q)
        assert (px * zi % q, py * zi % q) == (P[0].v, P[1].v)


def test_translate_rep3_to_shamir_equal_over_tcp_and_local(monkeypatch):
    x = rand_ints(FR.p, N, 321)
    xs = share_field_vec(FR, FR.encode(x), seed=322)

    def party(i, net):
        return [translate_rep3_to_shamir(BN254, net, xs[i])]

    tcp, local = _both_networks(monkeypatch, party)
    _assert_bit_equal(tcp, local)
    assert _ints(combine_field_shares_shamir(FR, [r[0] for r in tcp], 1)) == x


CODEC_CASES = [
    None, 0, -1, 1 << 300, True, b"\x00\x01seed", "name",
    np.arange(12, dtype=np.uint32).reshape(3, 4), np.uint64(7),
    np.zeros((0, 3), np.int32), np.array(True), np.array([1.5, -2.0]),
    (np.ones((2, 2), np.uint32), [np.zeros(3, np.int64), b"x"]),
    {"a": (1, 2), "b": None},
]


@pytest.mark.parametrize("case", range(len(CODEC_CASES)))
def test_codec_roundtrip_and_bytes_equal_reference(case):
    c = CODEC_CASES[case]
    raw = codec.encode(c)
    assert raw == ref_codec.encode(c)
    out = codec.decode(raw)
    if isinstance(c, np.generic):
        assert out == c
    elif isinstance(c, np.ndarray):
        # both codecs encode np.ascontiguousarray(c), which is at least 1-d:
        # a 0-d array crosses as shape (1,)
        assert out.dtype == c.dtype and out.shape == (c.shape or (1,))
        assert np.array_equal(out.reshape(c.shape), c)
    elif isinstance(c, tuple):
        assert isinstance(out, tuple) and isinstance(out[1], list)
    else:
        assert out == c


def test_codec_refuses_hostile_shapes():
    with pytest.raises(TypeError):
        codec.encode(object())
    with pytest.raises(TypeError):
        codec.encode(np.array([object()]))  # object dtype refused
    with pytest.raises(TypeError):
        codec.encode(torch.zeros(2))  # tensors cross as numpy (TcpNetwork.send)
    with pytest.raises(ValueError):
        codec.decode(b"\xff")  # unknown tag
    with pytest.raises(ValueError):
        codec.decode(codec.encode(5) + b"junk")  # trailing bytes
    with pytest.raises(ValueError):
        codec.decode(codec.encode((1, 2))[:-1])  # truncated
    assert codec.MAX_ITEMS == ref_codec.MAX_ITEMS and codec._DTYPES == ref_codec._DTYPES


def test_tensors_cross_the_mesh_with_dtype_and_values():
    """Every tensor arrives as a tensor on the receiving network's device,
    with its dtype, shape and values; NamedTuples arrive as plain tuples;
    both ends count the same frame bytes.  A 0-d tensor arrives with shape
    (1,), as a 0-d array does through the JAX package's codec."""
    src = torch.arange(24, dtype=torch.int64).reshape(4, 6)
    payload = (
        torch.tensor([-1, 2**31 - 1, -2**31], dtype=torch.int32),
        src.t(),                                            # not contiguous
        [torch.tensor([True, False]), torch.tensor(7, dtype=torch.int64)],
        {"u8": torch.arange(3, dtype=torch.uint8), "empty": torch.zeros((8, 0), dtype=torch.int32)},
        Rep3FieldShare(torch.ones((8, 2), dtype=torch.int32), torch.zeros((8, 2), dtype=torch.int32)),
        b"seed", "text", 12345, None,
    )

    def party(i, net):
        net.send_next(payload)
        got = net.recv_prev()
        return got, net.stats()

    got, (sent, recvd) = run_tcp(party)[0]
    assert sent == recvd > 0
    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            return [obj]
        items = obj.values() if isinstance(obj, dict) else obj
        return [t for o in items for t in tensors(o)]

    flat_got, flat_want = tensors(got[:5]), tensors(payload[:5])
    assert len(flat_got) == len(flat_want) == 8
    for g, w in zip(flat_got, flat_want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype == w.dtype and g.shape == (w.shape or (1,))
        assert torch.equal(g.reshape(w.shape), w)
    assert type(got[4]) is tuple and isinstance(got[2], list) and isinstance(got[3], dict)
    assert got[5:] == (b"seed", "text", 12345, None)


def test_tcp_rep3_mul():
    x, y = [3, 5, 7], [11, 13, 17]
    xs = share_field_vec(FR, FR.encode(x), seed=91)
    ys = share_field_vec(FR, FR.encode(y), seed=92)

    def party(i, net):
        d = Rep3Driver(BN254, net, device="cpu")
        return _ints(d.open_many(d.mul_vec(xs[i], ys[i])))

    results = run_tcp(party)
    assert results[0] == [a * b % FR.p for a, b in zip(x, y)] == results[1] == results[2]


def _certs(tmp_path, n):
    out = []
    for i in range(n):
        k, c = str(tmp_path / f"k{i}.pem"), str(tmp_path / f"c{i}.pem")
        gen_self_signed_cert(k, c)
        out.append((k, c))
    return out


def test_tcp_rep3_mul_tls(tmp_path):
    """The same multiplication over a mutually authenticated TLS mesh, and a
    connection without a pinned certificate is refused."""
    certs = _certs(tmp_path, 3)
    x, y = [3, 5], [7, 11]
    xs = share_field_vec(FR, FR.encode(x), seed=41)
    ys = share_field_vec(FR, FR.encode(y), seed=42)
    tls = [TlsConfig(certs[i][0], certs[i][1], party_cert_paths=[c for _, c in certs])
           for i in range(3)]

    def party(i, net):
        d = Rep3Driver(BN254, net, device="cpu")
        return _ints(d.open_many(d.mul_vec(xs[i], ys[i])))

    results = run_tcp(party, tls=tls)
    assert results[0] == [a * b % FR.p for a, b in zip(x, y)] == results[1] == results[2]

    # an interloper with a certificate nobody pinned cannot join party 0's mesh
    kx, cx = str(tmp_path / "kx.pem"), str(tmp_path / "cx.pem")
    gen_self_signed_cert(kx, cx)
    port = free_ports(1)[0]
    holder = {}

    def victim():
        try:
            holder["net"] = TcpNetwork(0, [("127.0.0.1", port), ("127.0.0.1", port + 1)],
                                       timeout=5, device="cpu",
                                       tls=TlsConfig(certs[0][0], certs[0][1],
                                                     [certs[0][1], certs[1][1]]))
        except BaseException as e:  # noqa: BLE001 — recorded and checked below
            holder["err"] = e

    t = threading.Thread(target=victim)
    t.start()
    time.sleep(0.3)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(cx, kx)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    with pytest.raises(ssl.SSLError):
        raw = socket.create_connection(("127.0.0.1", port), timeout=5)
        s = ctx.wrap_socket(raw)
        s.send(b"\x01\x00\x00\x00")
        s.recv(1)
    t.join(10)
    assert not t.is_alive() and "net" not in holder


def test_tls_mesh_completes_after_refusing_an_interloper(tmp_path):
    """A connection whose TLS handshake fails (a certificate nobody pinned)
    is refused and party 0 goes on accepting: the real parties still mesh
    and multiply."""
    certs = _certs(tmp_path, 4)
    tls = [TlsConfig(certs[i][0], certs[i][1], party_cert_paths=[c for _, c in certs[:3]])
           for i in range(3)]
    ports = free_ports(3)
    addrs = [("127.0.0.1", p) for p in ports]
    xs = share_field_vec(FR, FR.encode([6, 7]), seed=51)
    results, errors = [None] * 3, []

    def party(i):
        try:
            net = TcpNetwork(i, addrs, tls=tls[i], device="cpu", timeout=20)
            d = Rep3Driver(BN254, net, device="cpu")
            results[i] = _ints(d.open_many(d.mul_vec(xs[i], xs[i])))
            net.close()
        except BaseException as e:  # noqa: BLE001 — checked below
            errors.append(e)

    first = threading.Thread(target=party, args=(0,))
    first.start()
    time.sleep(0.3)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(certs[3][1], certs[3][0])
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    with pytest.raises((ssl.SSLError, OSError)):
        s = ctx.wrap_socket(socket.create_connection(addrs[0], timeout=5))
        s.send(b"\x01\x00\x00\x00")
        s.recv(1)
    rest = [threading.Thread(target=party, args=(i,)) for i in (1, 2)]
    for t in rest:
        t.start()
    for t in [first] + rest:
        t.join(60)
    assert not errors, errors
    assert results == [[36, 49]] * 3


def test_send_refuses_a_message_over_the_frame_cap(monkeypatch):
    """A message larger than MAX_FRAME raises at the sender, naming the cap,
    before anything reaches the wire."""
    monkeypatch.setattr(TcpNetwork, "MAX_FRAME", 1024)

    def party(i, net):
        if i == 0:
            with pytest.raises(ValueError, match="exceeds the 1024-byte frame cap"):
                net.send(1, torch.zeros(1024, dtype=torch.int32))
        net.send_next(torch.ones(8, dtype=torch.int32))
        return net.recv_prev(), net.stats()

    results = run_tcp(party)
    assert all(torch.equal(got, torch.ones(8, dtype=torch.int32)) for got, _ in results)
    assert results[0][1] == results[1][1] == results[2][1]


def test_tls_id_must_match_pinned_cert(tmp_path):
    """A peer holding a valid pinned certificate (party 2's) cannot claim
    another id (party 1): the claimed id is bound to that party's own
    certificate."""
    certs = _certs(tmp_path, 3)
    port = free_ports(1)[0]
    holder = {}

    def victim():
        try:
            tls = TlsConfig(certs[0][0], certs[0][1], party_cert_paths=[c for _, c in certs])
            holder["net"] = TcpNetwork(
                0, [("127.0.0.1", port), ("127.0.0.1", port + 1), ("127.0.0.1", port + 2)],
                timeout=4, tls=tls, device="cpu")
        except BaseException as e:  # noqa: BLE001 — recorded and checked below
            holder["err"] = e

    t = threading.Thread(target=victim)
    t.start()
    time.sleep(0.3)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(certs[2][1], certs[2][0])
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    s = ctx.wrap_socket(socket.create_connection(("127.0.0.1", port), timeout=5))
    s.send(b"\x01\x00\x00\x00")  # claim id 1
    got = b""
    try:
        got = s.recv(1)
    except (ssl.SSLError, OSError):
        pass
    assert got == b""  # dropped, nothing meshed
    t.join(15)
    assert not t.is_alive() and "net" not in holder and "err" in holder


def test_net_log_records_each_send_and_receive(tmp_path, monkeypatch):
    """COCIRCOM_NET_LOG=<path>: every party appends one line a send (peer
    and payload bytes) and one a receive (peer)."""
    log = tmp_path / "net.log"
    monkeypatch.setenv("COCIRCOM_NET_LOG", str(log))

    def party(i, net):
        net.send_next(torch.arange(4, dtype=torch.int32))
        return net.recv_prev()

    run_tcp(party)
    n = len(codec.encode(np.arange(4, dtype=np.int32)))
    want = ([f"send to={(i + 1) % 3} n={n}" for i in range(3)]
            + [f"recv frm={(i - 1) % 3}" for i in range(3)])
    assert sorted(log.read_text().splitlines()) == sorted(want)


def test_mesh_setup_ends_at_its_deadline_despite_a_silent_peer():
    """A connection that never sends its id cannot hold party 0's accept
    thread past the mesh's deadline: the set-up raises "mesh incomplete"
    and the thread has ended by then, not a socket timeout later."""
    port = free_ports(1)[0]
    holder = {}

    def victim():
        try:
            TcpNetwork(0, [("127.0.0.1", port), ("127.0.0.1", port + 1)], timeout=2.0,
                       device="cpu")
        except ConnectionError as e:
            holder["err"] = e
        holder["ended"] = time.monotonic()

    t = threading.Thread(target=victim)
    t.start()
    time.sleep(1.0)
    silent = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        t.join(10)
        assert not t.is_alive() and "mesh incomplete" in str(holder["err"])
        while (any(th.name == "net-accept-0" for th in threading.enumerate())
               and time.monotonic() < holder["ended"] + 0.5):
            time.sleep(0.02)
        assert not any(th.name == "net-accept-0" for th in threading.enumerate())
        silent.settimeout(5)
        assert silent.recv(1) == b""  # refused and closed by the deadline
        assert time.monotonic() < holder["ended"] + 0.5
    finally:
        silent.close()


def test_tcp_network_defaults_to_the_card_before_any_socket(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default device exists")

    def no_socket(*a, **k):
        raise AssertionError("TcpNetwork opened a socket before resolving its device")

    monkeypatch.setattr(socket, "socket", no_socket)
    with pytest.raises(RuntimeError, match="CUDA"):
        TcpNetwork(0, [("127.0.0.1", 1), ("127.0.0.1", 2)])
