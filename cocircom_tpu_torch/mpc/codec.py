"""Fixed-schema wire codec for MPC payloads: no pickle, nothing executable.

The upstream project serializes wire payloads with bincode over
ark-serialize (mpc-core/src/protocols/rep3/network.rs:172-191), a pure data
format.  This codec accepts exactly the value shapes MPC rounds produce
(numpy arrays of whitelisted dtypes, (nested) tuples/lists, str-keyed
dicts, bytes, str, ints, None) and nothing else; decoding untrusted bytes
can only ever yield those.  It is a copy of the JAX package's codec with the
same tags, dtype table and limits, so both packages put the same bytes on
the wire for the same numpy objects.  Tensors are turned into numpy arrays
by the network (mpc/net.py) before they reach it.

Frame layout (little-endian):
  tag u8, then per-type payload. Arrays: dtype-code u8, ndim u8,
  shape ndim*u32, C-order raw data. Containers: count u32 + items.
"""

from __future__ import annotations

import struct

import numpy as np

T_NONE, T_INT, T_BYTES, T_ARRAY, T_TUPLE, T_LIST, T_STR, T_DICT = range(8)

_DTYPES = [
    np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.uint32),
    np.dtype(np.uint64), np.dtype(np.int8), np.dtype(np.int16),
    np.dtype(np.int32), np.dtype(np.int64), np.dtype(np.bool_),
    np.dtype(np.float32), np.dtype(np.float64),
]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

MAX_ITEMS = 1 << 24  # containers; a frame is separately capped at 1 GB


def _enc(obj, out: list):
    if obj is None:
        out.append(struct.pack("<B", T_NONE))
    elif isinstance(obj, bool):
        # bools are ints in python; keep them as 0/1 ints on the wire
        out.append(struct.pack("<BI", T_INT, 1))
        out.append(b"\x01" if obj else b"\x00")
    elif isinstance(obj, int):
        raw = obj.to_bytes((obj.bit_length() + 8) // 8 or 1, "little", signed=True)
        out.append(struct.pack("<BI", T_INT, len(raw)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(struct.pack("<BI", T_BYTES, len(obj)))
        out.append(bytes(obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(struct.pack("<BI", T_STR, len(raw)))
        out.append(raw)
    elif isinstance(obj, np.generic):
        _enc(np.asarray(obj), out)
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        code = _DTYPE_CODE.get(a.dtype)
        if code is None:
            raise TypeError(f"dtype {a.dtype} not allowed on the wire")
        out.append(struct.pack("<BBB", T_ARRAY, code, a.ndim))
        out.append(struct.pack(f"<{a.ndim}I", *a.shape))
        out.append(a.tobytes())
    elif isinstance(obj, tuple):
        out.append(struct.pack("<BI", T_TUPLE, len(obj)))
        for it in obj:
            _enc(it, out)
    elif isinstance(obj, list):
        out.append(struct.pack("<BI", T_LIST, len(obj)))
        for it in obj:
            _enc(it, out)
    elif isinstance(obj, dict):
        out.append(struct.pack("<BI", T_DICT, len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError("dict keys on the wire must be str")
            _enc(k, out)
            _enc(v, out)
    else:
        raise TypeError(f"type {type(obj).__name__} not allowed on the wire")


def encode(obj) -> bytes:
    out: list = []
    _enc(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("truncated frame")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]


def _dec(r: _Reader):
    tag = r.u8()
    if tag == T_NONE:
        return None
    if tag == T_INT:
        return int.from_bytes(r.take(r.u32()), "little", signed=True)
    if tag == T_BYTES:
        return r.take(r.u32())
    if tag == T_STR:
        return r.take(r.u32()).decode()
    if tag == T_ARRAY:
        code = r.u8()
        if code >= len(_DTYPES):
            raise ValueError("unknown dtype code")
        dt = _DTYPES[code]
        ndim = r.u8()
        shape = struct.unpack(f"<{ndim}I", r.take(4 * ndim))
        count = 1
        for s in shape:
            count *= s
        raw = r.take(count * dt.itemsize)
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag in (T_TUPLE, T_LIST):
        n = r.u32()
        if n > MAX_ITEMS:
            raise ValueError("container too large")
        items = [_dec(r) for _ in range(n)]
        return tuple(items) if tag == T_TUPLE else items
    if tag == T_DICT:
        n = r.u32()
        if n > MAX_ITEMS:
            raise ValueError("container too large")
        out = {}
        for _ in range(n):
            k = _dec(r)
            if not isinstance(k, str):
                raise ValueError("dict key must be str")
            out[k] = _dec(r)
        return out
    raise ValueError(f"unknown tag {tag}")


def decode(data: bytes):
    r = _Reader(data)
    obj = _dec(r)
    if r.pos != len(data):
        raise ValueError("trailing bytes in frame")
    return obj
