# Frozen copy of cocircom_tpu_torch/honk/crs.py (commit e513b03), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""CRS for UltraHonk commitments.

The reference loads the Aztec Ignition BN254 setup from ~/.bb-crs g1/g2
.dat files (parse/crs.rs:44-66; the 6 GB g1.dat is NOT committed to the
repo, only bn254_g2.dat is). This build therefore supports two modes:

1. TestCrs — an INSECURE locally-generated setup with a known tau
   (deterministic, for tests/benches). Knowing tau makes commitment a
   polynomial evaluation + ONE scalar mul instead of an n-point MSM:
   commit(f) = f(tau)·G1. Proofs verify with the matching g2_x = tau·G2
   but anyone knowing tau can forge openings — never use in production.
2. FileCrs — real setup points from .dat files (g1: 64-byte uncompressed
   big-endian x||y per point, g2: single 128-byte point; format per
   crs.rs read_transcript_g1/g2). Commitment = MSM over the points
   (routed through a driver's MSM engine for large n: driver_msm).
"""

from __future__ import annotations

import hashlib

from ..fields.ec_host import ec_add, ec_mul
from ..fields.params import BN254
from ..pairing.tower import Fp, Fp2

P_FQ = BN254.fq.p
P_FR = BN254.fr.p


def _g1_gen():
    return (Fp(1, P_FQ), Fp(2, P_FQ))


def _g2_gen():
    c = BN254.g2_gen
    return (
        Fp2(Fp(c[0][0], P_FQ), Fp(c[0][1], P_FQ)),
        Fp2(Fp(c[1][0], P_FQ), Fp(c[1][1], P_FQ)),
    )


class TestCrs:
    """Known-tau test setup. commit(poly) = poly(tau)*G1 (exactly equal to
    the MSM over monomial powers tau^i * G1 — same group element).

    driver: an optional plain Driver; with one, poly(tau) is evaluated on
    its device (evaluate_poly_public: K1 products with the powers of tau
    and a sum) instead of by a host Horner loop, which takes seconds a
    polynomial at 2^20 coefficients.  The scalar mul stays on the host."""

    __test__ = False  # not a pytest class despite the name

    def __init__(self, seed: bytes = b"cocircom-tpu insecure test crs", driver=None):
        self.tau = int.from_bytes(hashlib.sha512(seed).digest(), "little") % P_FR
        self.g1 = _g1_gen()
        self.g2_gen = _g2_gen()
        self.g2_x = ec_mul(self.g2_gen, self.tau)
        self.driver = driver

    def commit(self, poly) -> tuple | None:
        """poly: list of int coefficients -> affine G1 point (or None=inf)."""
        if self.driver is not None:
            d = self.driver
            acc = int(d.fr.decode(d.evaluate_poly_public(d.fr.encode(poly), self.tau)
                                  .unsqueeze(-1))[0])
        else:
            acc = 0
            for c in reversed(poly):
                acc = (acc * self.tau + c) % P_FR
        if acc == 0:
            return None
        return ec_mul(self.g1, acc)


def g1_point_to_ints(pt) -> tuple[int, int] | None:
    if pt is None:
        return None
    return (pt[0].v, pt[1].v)


def read_g1_dat(path: str, num_points: int) -> list[tuple[int, int]]:
    """g1.dat: 64-byte uncompressed big-endian x||y per point (crs.rs
    read_transcript_g1). Reads the first num_points points."""
    with open(path, "rb") as f:
        raw = f.read(64 * num_points)
    if len(raw) < 64 * num_points:
        raise ValueError(
            f"g1.dat holds {len(raw) // 64} points, need {num_points}")
    return [
        (int.from_bytes(raw[i:i + 32], "big"),
         int.from_bytes(raw[i + 32:i + 64], "big"))
        for i in range(0, 64 * num_points, 64)
    ]


def write_g1_dat(path: str, points: list[tuple[int, int]]):
    """Inverse of read_g1_dat (fixture generation / setup export)."""
    with open(path, "wb") as f:
        for x, y in points:
            f.write(int(x).to_bytes(32, "big"))
            f.write(int(y).to_bytes(32, "big"))


def generate_test_setup_g1(n: int, tau: int) -> list[tuple[int, int]]:
    """Monomial setup points [tau^i * G1] for fixtures (INSECURE: known tau)."""
    pts = []
    acc = _g1_gen()
    pts.append((acc[0].v, acc[1].v))
    for _ in range(1, n):
        acc = ec_mul(_g1_gen(), pow(tau, len(pts), P_FR))
        pts.append((acc[0].v, acc[1].v))
    return pts


class FileCrs:
    """Real-setup CRS from .dat files (the reference's ~/.bb-crs layout,
    parse/crs.rs:44-66). Commitment = n-point MSM over the setup points.

    msm: optional callable (points:[(x,y)], scalars:[int]) -> (x,y)|None
    for routing large commits through the device MSM engine
    (parallel/sharded.py or ops/msm.py via a driver); defaults to a host
    loop, fine for test sizes."""

    def __init__(self, g1_path: str, g2_path: str, num_points: int,
                 msm=None):
        self.points = read_g1_dat(g1_path, num_points)
        # first setup point = tau^0 * G1 = the generator (Aztec Ignition)
        self.g1 = (Fp(self.points[0][0], P_FQ), Fp(self.points[0][1], P_FQ))
        self.g2_gen = _g2_gen()
        self.g2_x = read_g2_dat(g2_path)
        self._msm = msm or _host_msm

    def commit(self, poly) -> tuple | None:
        scalars = [c % P_FR for c in poly]
        if len(scalars) > len(self.points):
            raise ValueError("polynomial larger than the CRS")
        return self._msm(self.points[: len(scalars)], scalars)


def _host_msm(points, scalars, c: int = 8):
    """Host Pippenger (bucket method) over python-int coordinates."""
    pts = [(Fp(x, P_FQ), Fp(y, P_FQ)) for x, y in points]
    scal = [s % P_FR for s in scalars]
    nbits = max((s.bit_length() for s in scal), default=0)
    if nbits == 0:
        return None
    n_windows = (nbits + c - 1) // c
    result = None
    mask = (1 << c) - 1
    for w in reversed(range(n_windows)):
        buckets = [None] * mask
        shift = w * c
        for pt, s in zip(pts, scal):
            digit = (s >> shift) & mask
            if digit:
                buckets[digit - 1] = ec_add(buckets[digit - 1], pt)
        running = None
        window_acc = None
        for b in reversed(buckets):
            running = ec_add(running, b)
            window_acc = ec_add(window_acc, running)
        if result is not None:
            for _ in range(c):
                result = ec_add(result, result)
        result = ec_add(result, window_acc)
    return result


def driver_msm(d):
    """Adapter: route FileCrs commits through a plain Driver's curve/MSM
    engines — the device Pippenger path (ops/msm.py: K5 waves, K4 bucket
    reduction and Horner) for production-size commits."""
    from ..ops.curve import pmap

    def _msm(points, scalars):
        proj = d.g1.encode_points(list(points))
        res = d.msm_g1(proj, d.promote_public(d.fr.encode(
            [s % P_FR for s in scalars])))
        pt = d.g1.decode_points(pmap(lambda co: co.unsqueeze(-1), res))[0]
        if pt is None:
            return None
        return (Fp(pt[0], P_FQ), Fp(pt[1], P_FQ))

    return _msm


def read_g2_dat(path: str):
    """bn254_g2.dat: 128 bytes big-endian x.c0 x.c1 y.c0 y.c1 (crs.rs
    read_transcript_g2 new-format branch)."""
    raw = open(path, "rb").read()
    if len(raw) < 128:
        raise ValueError("g2.dat too small")
    vals = [int.from_bytes(raw[i * 32:(i + 1) * 32], "big") for i in range(4)]
    x = Fp2(Fp(vals[0], P_FQ), Fp(vals[1], P_FQ))
    y = Fp2(Fp(vals[2], P_FQ), Fp(vals[3], P_FQ))
    return (x, y)
