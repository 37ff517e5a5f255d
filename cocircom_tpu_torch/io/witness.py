"""circom .wtns witness files.

Parity: co-circom/circom-types/src/witness.rs:44-97.
Values are standard-form little-endian field elements (n8r bytes each).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..fields.params import CurveParams, curve_by_name
from ..ops.field import (
    bytes_to_limbs_np,
    limbs_np_to_bytes,
    limbs_np_to_ints,
)
from .binfile import read_binfile, write_binfile


@dataclass
class Witness:
    curve: CurveParams
    n_witness: int
    values_std: np.ndarray  # (L, n) uint32: 32-bit standard-form limbs (host)

    def values_ints(self) -> list[int]:
        return [int(v) for v in limbs_np_to_ints(self.values_std)]


def _n_limbs(curve: CurveParams) -> int:
    return -(-curve.fr.p.bit_length() // 32)


def _curve_from_modulus(modulus: int) -> CurveParams:
    for name in ("bn254", "bls12_381"):
        c = curve_by_name(name)
        if c.fr.p == modulus or c.fq.p == modulus:
            return c
    raise ValueError("unknown field modulus in artifact")


def read_wtns(data: bytes) -> Witness:
    bf = read_binfile(data, "wtns")
    hdr = bf.sections[1]
    (n8,) = struct.unpack_from("<I", hdr, 0)
    modulus = int.from_bytes(hdr[4 : 4 + n8], "little")
    (n_witness,) = struct.unpack_from("<I", hdr, 4 + n8)
    curve = _curve_from_modulus(modulus)
    vals = bytes_to_limbs_np(bf.sections[2], n_witness, _n_limbs(curve))
    return Witness(curve, n_witness, vals)


def write_wtns(curve: CurveParams, values_std: np.ndarray) -> bytes:
    n = values_std.shape[1]
    n8 = 4 * _n_limbs(curve)
    hdr = struct.pack("<I", n8) + curve.fr.p.to_bytes(n8, "little") + struct.pack("<I", n)
    payload = limbs_np_to_bytes(values_std)
    return write_binfile("wtns", 2, [(1, hdr), (2, payload)])
