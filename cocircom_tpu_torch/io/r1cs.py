"""circom .r1cs files.

Parity: co-circom/circom-types/src/r1cs.rs. Coefficients are
standard-form LE field elements (from_reader semantics).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..fields.params import CurveParams
from .binfile import read_binfile
from .witness import _curve_from_modulus


@dataclass
class R1CS:
    curve: CurveParams
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    n_constraints: int
    # constraints[i] = (A, B, C) with each a list[(wire, coeff_int)]
    constraints: list
    wire_mapping: list[int]

    @property
    def num_inputs(self) -> int:
        return 1 + self.n_pub_in + self.n_pub_out


def read_r1cs(data: bytes) -> R1CS:
    bf = read_binfile(data, "r1cs")
    hdr = bf.sections[1]
    (n8,) = struct.unpack_from("<I", hdr, 0)
    prime = int.from_bytes(hdr[4 : 4 + n8], "little")
    off = 4 + n8
    n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack_from("<IIII", hdr, off)
    off += 16
    (n_labels,) = struct.unpack_from("<Q", hdr, off)
    off += 8
    (n_constraints,) = struct.unpack_from("<I", hdr, off)
    curve = _curve_from_modulus(prime)

    sec = bf.sections[2]
    pos = 0
    constraints = []
    for _ in range(n_constraints):
        lcs = []
        for _ in range(3):
            (cnt,) = struct.unpack_from("<I", sec, pos)
            pos += 4
            terms = []
            for _ in range(cnt):
                (wire,) = struct.unpack_from("<I", sec, pos)
                pos += 4
                coeff = int.from_bytes(sec[pos : pos + n8], "little")
                pos += n8
                terms.append((wire, coeff))
            lcs.append(terms)
        constraints.append(tuple(lcs))

    mapping = []
    if 3 in bf.sections:
        m = bf.sections[3]
        mapping = list(np.frombuffer(m, dtype="<u8", count=len(m) // 8))
    return R1CS(
        curve=curve,
        n_wires=n_wires,
        n_pub_out=n_pub_out,
        n_pub_in=n_pub_in,
        n_prv_in=n_prv_in,
        n_labels=int(n_labels),
        n_constraints=n_constraints,
        constraints=constraints,
        wire_mapping=[int(x) for x in mapping],
    )


def multiplier_chain(curve: CurveParams, n_mul: int, a_val: int):
    """A hand-built fixture circuit: y = a^(n_mul+1) as a chain of n_mul
    multiplications.  Wires: 0 = 1, 1 = y (public output), 2 = a (public
    input), 3.. = intermediates.  Returns (r1cs, witness values as ints)."""
    p = curve.fr.p
    vals = [1, None, a_val % p]
    cons = []
    cur = 2
    for i in range(n_mul):
        out = 1 if i == n_mul - 1 else len(vals)
        cons.append(([(cur, 1)], [(2, 1)], [(out, 1)]))
        v = vals[cur] * vals[2] % p
        if out == 1:
            vals[1] = v
        else:
            vals.append(v)
        cur = out
    r1cs = R1CS(curve=curve, n_wires=len(vals), n_pub_out=1, n_pub_in=1, n_prv_in=0,
                n_labels=len(vals), n_constraints=len(cons), constraints=cons,
                wire_mapping=[])
    return r1cs, vals
