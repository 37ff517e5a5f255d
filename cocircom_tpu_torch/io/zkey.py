"""snarkjs Groth16 .zkey parsing into torch tensors on a device.

Sections: 1 prover-type, 2 header(+vk points), 3 IC, 4 coeffs (constraint
matrices), 5 a_query, 6 b_g1, 7 b_g2, 8 l_query (n_vars-n_public-1),
9 h_query (domain_size).

Encodings:
  * Point coordinates: little-endian Montgomery residues with R = 2^(8*n8),
    identical to the port's Montgomery R, so query arrays are loaded as
    32-bit limb tensors by reinterpreting the bytes.
  * Matrix coefficients: stored as value*R^2; one `from_mont` (divide by R)
    turns them into Montgomery form value*R.
  * Point at infinity: (0, 0).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..fields.params import CurveParams, curve_by_name
from ..ops.field import Field, get_field, resolve_device
from .binfile import read_binfile


@dataclass
class G1Array:
    """Batch of affine G1 points as Montgomery limb tensors (L, N)."""

    x: torch.Tensor
    y: torch.Tensor

    @property
    def n(self):
        return self.x.shape[1]


@dataclass
class G2Array:
    x0: torch.Tensor
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor

    @property
    def n(self):
        return self.x0.shape[1]


@dataclass
class SparseMatrices:
    """COO A/B constraint matrices (C is implicit: A.w * B.w = C.w)."""

    num_constraints: int
    num_instance: int  # n_public + 1
    # per matrix: constraint index int64[nnz], signal int64[nnz], both on
    # the device, and Montgomery coefficients (L, nnz)
    a_rows: torch.Tensor
    a_cols: torch.Tensor
    a_coeffs: torch.Tensor
    b_rows: torch.Tensor
    b_cols: torch.Tensor
    b_coeffs: torch.Tensor


@dataclass
class Groth16ZKey:
    curve: CurveParams
    n_vars: int
    n_public: int
    domain_size: int
    pow: int
    # single points (host affine ints; None = infinity)
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    ic: G1Array
    a_query: G1Array
    b_g1_query: G1Array
    b_g2_query: G2Array
    l_query: G1Array
    h_query: G1Array
    matrices: SparseMatrices


def _coords(fq: Field, data: bytes, n: int, k: int):
    """n points of k coordinates each -> k tensors (L, n)."""
    a = np.frombuffer(data, dtype="<u4", count=n * k * fq.L).reshape(n, k, fq.L)
    return [fq.from_numpy(np.ascontiguousarray(a[:, i, :].T)) for i in range(k)]


def _g1_array(fq: Field, data: bytes, n: int) -> G1Array:
    return G1Array(*_coords(fq, data, n, 2))


def _g2_array(fq: Field, data: bytes, n: int) -> G2Array:
    return G2Array(*_coords(fq, data, n, 4))


def _mont_to_int(fq: Field, data: bytes) -> int:
    s = int.from_bytes(data, "little")
    return s * pow(fq.R, -1, fq.p) % fq.p


def _g1_point(fq: Field, data: bytes):
    n8 = 4 * fq.L
    x = _mont_to_int(fq, data[:n8])
    y = _mont_to_int(fq, data[n8: 2 * n8])
    if x == 0 and y == 0:
        return None
    return (x, y)


def _g2_point(fq: Field, data: bytes):
    n8 = 4 * fq.L
    x0 = _mont_to_int(fq, data[:n8])
    x1 = _mont_to_int(fq, data[n8: 2 * n8])
    y0 = _mont_to_int(fq, data[2 * n8: 3 * n8])
    y1 = _mont_to_int(fq, data[3 * n8: 4 * n8])
    if x0 == x1 == y0 == y1 == 0:
        return None
    return ((x0, x1), (y0, y1))


def read_groth16_zkey(data: bytes, device=None) -> Groth16ZKey:
    """Parse zkey bytes; the query arrays and matrices land on `device`
    (default: the card)."""
    device = resolve_device(device)
    bf = read_binfile(data, "zkey")
    (prover_type,) = struct.unpack("<I", bf.sections[1])
    if prover_type != 1:
        raise ValueError(f"not a groth16 zkey (prover type {prover_type})")
    hdr = bf.sections[2]
    off = 0
    (n8q,) = struct.unpack_from("<I", hdr, off)
    off += 4
    q = int.from_bytes(hdr[off: off + n8q], "little")
    off += n8q
    (n8r,) = struct.unpack_from("<I", hdr, off)
    off += 4
    r = int.from_bytes(hdr[off: off + n8r], "little")
    off += n8r
    n_vars, n_public, domain_size = struct.unpack_from("<III", hdr, off)
    off += 12
    curve = next((c for c in map(curve_by_name, ("bn254", "bls12_381"))
                  if c.fq.p == q and c.fr.p == r), None)
    if curve is None:
        raise ValueError("unknown curve moduli in zkey header")
    if domain_size == 0 or domain_size & (domain_size - 1):
        raise ValueError(f"domain size {domain_size} not a power of two")
    fq = get_field(curve.fq.p, curve.name + ".fq", device)
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    g1sz, g2sz = 8 * fq.L, 16 * fq.L
    alpha_g1 = _g1_point(fq, hdr[off: off + g1sz])
    off += g1sz
    beta_g1 = _g1_point(fq, hdr[off: off + g1sz])
    off += g1sz
    beta_g2 = _g2_point(fq, hdr[off: off + g2sz])
    off += g2sz
    gamma_g2 = _g2_point(fq, hdr[off: off + g2sz])
    off += g2sz
    delta_g1 = _g1_point(fq, hdr[off: off + g1sz])
    off += g1sz
    delta_g2 = _g2_point(fq, hdr[off: off + g2sz])

    return Groth16ZKey(
        curve=curve,
        n_vars=n_vars,
        n_public=n_public,
        domain_size=domain_size,
        pow=domain_size.bit_length() - 1,
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g1=delta_g1,
        delta_g2=delta_g2,
        ic=_g1_array(fq, bf.sections[3], n_public + 1),
        a_query=_g1_array(fq, bf.sections[5], n_vars),
        b_g1_query=_g1_array(fq, bf.sections[6], n_vars),
        b_g2_query=_g2_array(fq, bf.sections[7], n_vars),
        l_query=_g1_array(fq, bf.sections[8], n_vars - n_public - 1),
        h_query=_g1_array(fq, bf.sections[9], domain_size),
        matrices=_read_matrices(fr, bf.sections[4], n_public),
    )


def _read_matrices(fr: Field, data: bytes, n_public: int) -> SparseMatrices:
    """Parse section 4: entries whose constraint index lands in the trailing
    n_public rows (snarkjs' public-input equality constraints) are dropped;
    coefficients v*R^2 -> v*R (Montgomery form)."""
    (num_coeffs,) = struct.unpack_from("<I", data, 0)
    n8r = 4 * fr.L
    rec = np.dtype(
        [("matrix", "<u4"), ("constraint", "<u4"), ("signal", "<u4"), ("value", "V%d" % n8r)]
    )
    entries = np.frombuffer(data, dtype=rec, count=num_coeffs, offset=4)
    max_constraint = int(entries["constraint"].max()) if num_coeffs else 0
    num_constraints = max_constraint - n_public
    entries = entries[entries["constraint"] < num_constraints]
    raw = np.frombuffer(entries["value"].tobytes(), dtype="<u4").reshape(-1, fr.L)
    coeffs = fr.from_mont(fr.from_numpy(np.ascontiguousarray(raw.T)))
    mats = {}
    for mid in (0, 1):
        sel = entries["matrix"] == mid
        idx = torch.from_numpy(np.nonzero(sel)[0]).to(fr.device)
        mats[mid] = (
            torch.from_numpy(entries["constraint"][sel].astype(np.int64)).to(fr.device),
            torch.from_numpy(entries["signal"][sel].astype(np.int64)).to(fr.device),
            coeffs.index_select(1, idx).contiguous(),
        )
    return SparseMatrices(
        num_constraints=num_constraints,
        num_instance=n_public + 1,
        a_rows=mats[0][0],
        a_cols=mats[0][1],
        a_coeffs=mats[0][2],
        b_rows=mats[1][0],
        b_cols=mats[1][1],
        b_coeffs=mats[1][2],
    )
