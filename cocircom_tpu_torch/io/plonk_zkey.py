"""snarkjs PLONK .zkey parsing into torch tensors on a device.

Sections: 1 prover-type(2), 2 header+vk, 3 additions, 4/5/6 wire maps,
7..11 selector polys (qm,ql,qr,qo,qc), 12 sigma1|2|3, 13 lagrange,
14 p_tau (domain_size+6 G1 points). Each "polynomial" = domain_size
Montgomery coeffs followed by 4*domain_size extended-domain evaluations.
Field elements are Montgomery residues with the port's R, so they load by
reinterpreting the bytes as 32-bit limbs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..fields.params import CurveParams, curve_by_name
from ..ops.field import Field, get_field, resolve_device
from .binfile import read_binfile
from .zkey import G1Array, _g1_array, _g1_point, _g2_point, _mont_to_int


@dataclass
class CircomPoly:
    """coeffs (L, n) + extended evals (L, 4n), Montgomery limbs."""

    coeffs: torch.Tensor
    evals: torch.Tensor


@dataclass
class PlonkZKey:
    curve: CurveParams
    n_vars: int
    n_public: int
    domain_size: int
    power: int
    n_additions: int
    n_constraints: int
    # verifying key (host affine ints)
    k1: int
    k2: int
    qm_c: tuple
    ql_c: tuple
    qr_c: tuple
    qo_c: tuple
    qc_c: tuple
    s1_c: tuple
    s2_c: tuple
    s3_c: tuple
    x_2: tuple
    # additions: ids int64[n] (host), factors (L, n) Montgomery (device)
    add_id1: np.ndarray
    add_id2: np.ndarray
    add_f1: torch.Tensor
    add_f2: torch.Tensor
    # wire maps int64[n_constraints] (host)
    map_a: np.ndarray
    map_b: np.ndarray
    map_c: np.ndarray
    qm: CircomPoly
    ql: CircomPoly
    qr: CircomPoly
    qo: CircomPoly
    qc: CircomPoly
    s1: CircomPoly
    s2: CircomPoly
    s3: CircomPoly
    lagrange: list[CircomPoly]
    p_tau: G1Array


def _fr_array(fr: Field, data: bytes, n: int, off: int = 0) -> torch.Tensor:
    a = np.frombuffer(data, dtype="<u4", count=n * fr.L, offset=off)
    return fr.from_numpy(np.ascontiguousarray(a.reshape(n, fr.L).T))


def _poly(fr: Field, data: bytes, domain_size: int, off: int = 0) -> CircomPoly:
    n8r = 4 * fr.L
    coeffs = _fr_array(fr, data, domain_size, off)
    evals = _fr_array(fr, data, 4 * domain_size, off + domain_size * n8r)
    return CircomPoly(coeffs, evals)


def read_plonk_zkey(data: bytes, device=None) -> PlonkZKey:
    """Parse zkey bytes; polynomials, factors and p_tau land on `device`
    (default: the card)."""
    device = resolve_device(device)
    bf = read_binfile(data, "zkey")
    (prover_type,) = struct.unpack("<I", bf.sections[1])
    if prover_type != 2:
        raise ValueError(f"not a plonk zkey (prover type {prover_type})")
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
    n_vars, n_public, domain_size, n_additions, n_constraints = struct.unpack_from(
        "<IIIII", hdr, off)
    off += 20
    curve = next((c for c in map(curve_by_name, ("bn254", "bls12_381"))
                  if c.fq.p == q and c.fr.p == r), None)
    if curve is None:
        raise ValueError("unknown curve moduli in plonk zkey")
    fq = get_field(curve.fq.p, curve.name + ".fq", device)
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    k1 = _mont_to_int(fr, hdr[off: off + n8r])
    off += n8r
    k2 = _mont_to_int(fr, hdr[off: off + n8r])
    off += n8r
    g1sz, g2sz = 8 * fq.L, 16 * fq.L
    pts = []
    for _ in range(8):
        pts.append(_g1_point(fq, hdr[off: off + g1sz]))
        off += g1sz
    x_2 = _g2_point(fq, hdr[off: off + g2sz])

    rec = np.dtype([("id1", "<u4"), ("id2", "<u4"), ("f1", "V%d" % n8r), ("f2", "V%d" % n8r)])
    entries = np.frombuffer(bf.sections[3], dtype=rec, count=n_additions)

    def factors(name):
        return _fr_array(fr, entries[name].tobytes(), n_additions) if n_additions \
            else fr.zeros((0,))

    def wire_map(sid):
        return np.frombuffer(bf.sections[sid], dtype="<u4", count=n_constraints).astype(np.int64)

    polys = {name: _poly(fr, bf.sections[sid], domain_size)
             for name, sid in (("qm", 7), ("ql", 8), ("qr", 9), ("qo", 10), ("qc", 11))}
    sig = bf.sections[12]
    sig_sz = 5 * domain_size * n8r
    return PlonkZKey(
        curve=curve,
        n_vars=n_vars,
        n_public=n_public,
        domain_size=domain_size,
        power=domain_size.bit_length() - 1,
        n_additions=n_additions,
        n_constraints=n_constraints,
        k1=k1,
        k2=k2,
        qm_c=pts[0],
        ql_c=pts[1],
        qr_c=pts[2],
        qo_c=pts[3],
        qc_c=pts[4],
        s1_c=pts[5],
        s2_c=pts[6],
        s3_c=pts[7],
        x_2=x_2,
        add_id1=entries["id1"].astype(np.int64),
        add_id2=entries["id2"].astype(np.int64),
        add_f1=factors("f1"),
        add_f2=factors("f2"),
        map_a=wire_map(4),
        map_b=wire_map(5),
        map_c=wire_map(6),
        s1=_poly(fr, sig, domain_size, 0),
        s2=_poly(fr, sig, domain_size, sig_sz),
        s3=_poly(fr, sig, domain_size, 2 * sig_sz),
        lagrange=[_poly(fr, bf.sections[13], domain_size, i * sig_sz) for i in range(n_public)],
        p_tau=_g1_array(fq, bf.sections[14], domain_size + 6),
        **polys,
    )
