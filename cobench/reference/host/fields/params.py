# Frozen copy of cocircom_tpu_torch/fields/params.py (commit c520732), kept for the
# benchmark's reference: host Python integers only; its relative imports
# resolve inside cobench/reference/host.  Do not edit to follow the program.
"""Curve and field constants for BN254 (alt_bn128 / bn128) and BLS12-381.

Host-side (python-int) field helpers live here too; they are the ground truth
that the limb kernels (ops/field.py) are property-tested
against, and they power the (host-side) pairing verifier and artifact I/O.

Parity notes (reference: upstream co-circom):
  - Curves supported mirror co-circom/co-circom/src/lib.rs:55-60 (BN254 + BLS12-381).
  - The snarkjs root-of-unity convention mirrors
    co-circom/co-circom-snarks/src/lib.rs:208-221 (smallest QNR q, g = q^trace,
    roots by repeated squaring, reversed).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass


@dataclass(frozen=True, eq=False)
class HostField:
    """A prime field with python-int arithmetic (host-side ground truth)."""

    p: int
    name: str = "F"

    @property
    def bits(self) -> int:
        return self.p.bit_length()

    # number of 8-byte-free bytes circom uses on the wire (n8): ceil(bits/8)
    @property
    def n8(self) -> int:
        return (self.bits + 7) // 8

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, -1, self.p)

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inv(b))

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def legendre(self, a: int) -> int:
        """1 if QR, -1 if QNR, 0 if zero."""
        ls = pow(a % self.p, (self.p - 1) // 2, self.p)
        return -1 if ls == self.p - 1 else ls

    def sqrt(self, a: int) -> int | None:
        """Tonelli-Shanks; returns one square root or None."""
        a %= self.p
        if a == 0:
            return 0
        if self.legendre(a) != 1:
            return None
        p = self.p
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # Tonelli-Shanks
        s, q = 0, p - 1
        while q % 2 == 0:
            s += 1
            q //= 2
        z = self.smallest_qnr
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r

    @functools.cached_property
    def two_adicity(self) -> int:
        s, q = 0, self.p - 1
        while q % 2 == 0:
            s += 1
            q //= 2
        return s

    @functools.cached_property
    def trace(self) -> int:
        """Odd t with p - 1 = 2^s * t."""
        return (self.p - 1) >> self.two_adicity

    @functools.cached_property
    def smallest_qnr(self) -> int:
        q = 2
        while self.legendre(q) != -1:
            q += 1
        return q

    @functools.cached_property
    def snarkjs_roots(self) -> tuple[int, list[int]]:
        """(q, roots) exactly as co-circom-snarks/src/lib.rs:208-221.

        roots[k] is a primitive 2^k-th root of unity (roots[0] == 1).
        """
        s = self.two_adicity
        q = self.smallest_qnr
        z = pow(q, self.trace, self.p)
        roots = [0] * (s + 1)
        roots[0] = z
        for i in range(1, s + 1):
            roots[i] = roots[i - 1] * roots[i - 1] % self.p
        roots.reverse()
        return q, roots

    def root_of_unity(self, pow2: int) -> int:
        """Primitive 2^pow2-th root of unity, snarkjs convention."""
        _, roots = self.snarkjs_roots
        return roots[pow2]

    def groth16_coset_root(self, pow2: int) -> int:
        """Coset shift generator, co-groth16/src/groth16.rs:57-77 semantics."""
        q, roots = self.snarkjs_roots
        if pow2 == self.two_adicity:
            return q * q % self.p
        return roots[pow2 + 1]

    # --- byte conversions (little-endian, circom wire format) ---

    def to_bytes(self, a: int) -> bytes:
        return int(a % self.p).to_bytes(self.n8, "little")

    def from_bytes(self, b: bytes) -> int:
        return int.from_bytes(b, "little")


@dataclass(frozen=True, eq=False)
class CurveParams:
    """Pairing-friendly curve constants."""

    name: str  # our name
    circom_name: str  # name circom/snarkjs uses ("bn128", "bls12381")
    fq: HostField
    fr: HostField
    b: int  # G1: y^2 = x^3 + b
    g1_gen: tuple[int, int]
    # G2 over Fq2 = Fq[u]/(u^2+1): coords ((x0,x1),(y0,y1)); b2 = (b2_0, b2_1)
    b2: tuple[int, int]
    g2_gen: tuple[tuple[int, int], tuple[int, int]]
    # curve parameter (seed) x: BN254 t-param / BLS12-381 (negative) seed
    x: int = 0
    x_is_negative: bool = False
    cofactor_g1: int = 1
    # Fp6/Fp12 tower non-residue xi = xi0 + xi1*u  (Fp2 = Fp[u]/(u^2+1))
    xi: tuple[int, int] = (0, 0)
    # twist type: "D" (E': y^2 = x^3 + b/xi) or "M" (E': y^2 = x^3 + b*xi)
    twist: str = "D"


_BN254_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

BN254 = CurveParams(
    name="bn254",
    circom_name="bn128",
    fq=HostField(_BN254_P, "bn254.Fq"),
    fr=HostField(_BN254_R, "bn254.Fr"),
    b=3,
    g1_gen=(1, 2),
    # b2 = 3 / (9 + u)
    b2=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    g2_gen=(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    ),
    x=4965661367192848881,
    x_is_negative=False,
    xi=(9, 1),
    twist="D",
)

_BLS_P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
_BLS_R = int("73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16)

BLS12_381 = CurveParams(
    name="bls12_381",
    circom_name="bls12381",
    fq=HostField(_BLS_P, "bls12_381.Fq"),
    fr=HostField(_BLS_R, "bls12_381.Fr"),
    b=4,
    g1_gen=(
        3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    ),
    # b2 = 4 * (1 + u)
    b2=(4, 4),
    g2_gen=(
        (
            352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
            3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
        ),
        (
            1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
            927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
        ),
    ),
    x=0xD201000000010000,
    x_is_negative=True,
    xi=(1, 1),
    twist="M",
)

_CURVES = {"bn254": BN254, "bn128": BN254, "bls12_381": BLS12_381, "bls12381": BLS12_381}


def curve_by_name(name: str) -> CurveParams:
    key = name.lower().replace("-", "_")
    if key not in _CURVES:
        raise ValueError(f"unknown curve {name!r}; supported: bn254, bls12_381")
    return _CURVES[key]
