"""(De)serialization of secret-shared artifacts (.shared files).

The upstream project hands its pipeline from phase to phase in bincode files
(bin/co-circom.rs:212-217).  These are the JAX package's npz containers:
  header (json, key ``__meta__``): magic, protocol, curve and the publics
  arrays: the share components
with the same magics and keys, and the arrays in the JAX package's layout:
2L limbs of 16 bits in uint32, limb axis first.  The port's (L, n) int32
tensors of 32-bit limbs are unpacked on write (``unpack32_to_16``) and
packed on read (``pack16_to_32``), so a file that either package writes is
read by the other.  Readers put the shares on `device`: the card unless the
caller names another.
"""

from __future__ import annotations

import io as _io
import json

import numpy as np
import torch

from ..fields.params import curve_by_name
from ..ops.field import pack16_to_32, resolve_device, unpack32_to_16

WITNESS_MAGIC = "cocircom-tpu-shared-witness"
INPUT_MAGIC = "cocircom-tpu-shared-input"


def _pack(header: dict, arrays: dict) -> bytes:
    buf = _io.BytesIO()
    meta = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(buf, __meta__=meta, **arrays)
    return buf.getvalue()


def _unpack(data: bytes):
    z = np.load(_io.BytesIO(data), allow_pickle=False)
    header = json.loads(bytes(z["__meta__"]).decode())
    return header, z


def _to_file(t: torch.Tensor) -> np.ndarray:
    """(L, *batch) int32 tensor -> (2L, *batch) uint32 16-bit limbs."""
    return unpack32_to_16(t.detach()).to(torch.int32).cpu().numpy().view(np.uint32)


def _from_file(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """(2L, *batch) 16-bit limbs -> (L, *batch) int32 tensor on `device`."""
    limbs16 = np.asarray(a)
    if limbs16.dtype != np.uint32 or (limbs16 >> 16).any():
        raise ValueError("share arrays must hold 16-bit limbs in uint32")
    return pack16_to_32(torch.from_numpy(limbs16.view(np.int32)).to(device))


def write_shared_witness(protocol: str, curve_name: str, publics: list,
                         share_arrays: dict) -> bytes:
    """`share_arrays`: numpy arrays already in the file layout."""
    header = {
        "magic": WITNESS_MAGIC,
        "protocol": protocol,
        "curve": curve_name,
        "publics": [str(int(x)) for x in publics],
    }
    return _pack(header, share_arrays)


def read_shared_witness(data: bytes):
    """bytes -> (protocol, curve name, publics, {key: numpy array in the file
    layout})."""
    header, z = _unpack(data)
    if header.get("magic") != WITNESS_MAGIC:
        raise ValueError("not a shared witness file")
    publics = [int(s) for s in header["publics"]]
    arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return header["protocol"], header["curve"], publics, arrays


def write_shared_input(protocol: str, curve_name: str, si) -> bytes:
    """SharedInput -> bytes.  Share components are stored per signal name
    (rep3: a.<name> and b.<name>; shamir and plain: w.<name>); no pickle.
    The upstream SharedInput files: bin/co-circom.rs:327-332."""
    header = {
        "magic": INPUT_MAGIC,
        "protocol": protocol,
        "curve": curve_name,
        "public_inputs": {k: [str(int(x)) for x in v] for k, v in si.public_inputs.items()},
    }
    arrays = {}
    for name, share in si.shared_inputs.items():
        if protocol == "rep3":
            arrays[f"a.{name}"] = _to_file(share.a)
            arrays[f"b.{name}"] = _to_file(share.b)
        else:
            arrays[f"w.{name}"] = _to_file(share)
    return _pack(header, arrays)


def read_shared_input(data: bytes, device=None):
    """bytes -> (protocol, curve, SharedInput with the driver's shares on
    `device`)."""
    from ..mpc.rep3 import Rep3FieldShare
    from ..snark.shared import SharedInput

    device = resolve_device(device)
    header, z = _unpack(data)
    if header.get("magic") != INPUT_MAGIC:
        raise ValueError("not a shared input file")
    protocol = header["protocol"]
    publics = {k: [int(s) for s in v] for k, v in header["public_inputs"].items()}
    shared = {}
    for key in z.files:
        if key == "__meta__":
            continue
        kind, name = key.split(".", 1)
        if protocol == "rep3":
            if kind != "a":
                continue
            shared[name] = Rep3FieldShare(_from_file(z[f"a.{name}"], device),
                                          _from_file(z[f"b.{name}"], device))
        else:
            shared[name] = _from_file(z[key], device)
    return protocol, curve_by_name(header["curve"]), SharedInput(publics, shared)


def shared_witness_from_split(protocol: str, curve, sw) -> bytes:
    """SharedWitness (the driver's share) -> bytes."""
    if protocol in ("plain", "shamir"):
        arrays = {"w": _to_file(sw.witness)}
    elif protocol == "rep3":
        arrays = {"a": _to_file(sw.witness.a), "b": _to_file(sw.witness.b)}
    else:
        raise ValueError(protocol)
    return write_shared_witness(protocol, curve.name, sw.public_inputs, arrays)


def shared_witness_to_split(data: bytes, device=None):
    """bytes -> (protocol, curve, SharedWitness with the driver's share on
    `device`)."""
    from ..mpc.rep3 import Rep3FieldShare
    from ..snark.groth16 import SharedWitness

    device = resolve_device(device)
    protocol, curve_name, publics, arrays = read_shared_witness(data)
    curve = curve_by_name(curve_name)
    if protocol == "rep3":
        share = Rep3FieldShare(_from_file(arrays["a"], device), _from_file(arrays["b"], device))
    else:
        share = _from_file(arrays["w"], device)
    return protocol, curve, SharedWitness(publics, share)
