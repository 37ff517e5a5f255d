"""Groth16 trusted setup + snarkjs .zkey writer (`snarkjs groth16 setup`
equivalent): fresh circuits become provable without any snarkjs-side
artifacts.

Given an .r1cs (io/r1cs.py), samples toxic waste (tau, alpha, beta, gamma,
delta), evaluates the QAP at tau in the Lagrange basis, and emits a zkey
byte-compatible with io/zkey.read_groth16_zkey — the same binfile layout
snarkjs writes (sections 1 prover-type, 2 header, 3 IC, 4 coeffs,
5 a_query, 6 b_g1, 7 b_g2, 8 l_query, 9 h_query; parity:
co-circom/circom-types/src/groth16/zkey.rs).

Conventions matched to our prover (snark/groth16.py, itself bit-compatible
with committed snarkjs zkeys):
  * n_public + 1 extra A-rows binding the instance wires (snarkjs
    zkey_new.js; the prover's `set_slice(a, num_constraints, pub)`).
  * h_query in the COSET-LAGRANGE basis: the prover's h vector is the
    coset evaluation of A*B - C, with coset shift g = the 2n-th root
    (fields/params.groth16_coset_root), so Z is the constant g^n - 1 on
    the coset and
        h_query[i] = L_i(tau/g) * Z(tau) / (delta * (g^n - 1)) * G1.

This is a SINGLE-PARTY setup: whoever runs it sees the toxic waste. Use
the phase-2 ceremony of snarkjs for production keys; this module covers
the local/test/development loop the reference delegates to snarkjs.
"""

from __future__ import annotations

import secrets
import struct

from ..fields.ec_host import ec_mul
from ..fields.params import CurveParams
from ..io.binfile import write_binfile
from ..io.r1cs import R1CS
from ..pairing.tower import Fp, Fp2


def _batch_inv(vals: list[int], p: int) -> list[int]:
    """Montgomery batch inversion; zeros are not allowed."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % p
    inv = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % p
        inv = inv * vals[i] % p
    return out


def _g1(curve: CurveParams):
    q = curve.fq.p
    return (Fp(curve.g1_gen[0], q), Fp(curve.g1_gen[1], q))


def _g2(curve: CurveParams):
    q = curve.fq.p
    c = curve.g2_gen
    return (Fp2(Fp(c[0][0], q), Fp(c[0][1], q)),
            Fp2(Fp(c[1][0], q), Fp(c[1][1], q)))


def _g1_ints(pt):
    return None if pt is None else (pt[0].v, pt[1].v)


def _g2_ints(pt):
    if pt is None:
        return None
    return ((pt[0].c0.v, pt[0].c1.v), (pt[1].c0.v, pt[1].c1.v))


class _ZkeyEnc:
    """Montgomery little-endian encoders (zkey wire format)."""

    def __init__(self, curve: CurveParams):
        self.qp = curve.fq.p
        self.rp = curve.fr.p
        self.n8q = curve.fq.n8
        self.n8r = curve.fr.n8
        self.Rq = pow(2, 8 * self.n8q, self.qp)
        self.Rr = pow(2, 8 * self.n8r, self.rp)

    def fq(self, v: int) -> bytes:
        return (v * self.Rq % self.qp).to_bytes(self.n8q, "little")

    def fr2(self, v: int) -> bytes:
        """Coefficient encoding: v * R^2 (io/zkey.py applies one from_mont)."""
        return (v * self.Rr % self.rp * self.Rr % self.rp).to_bytes(
            self.n8r, "little")

    def g1(self, pt) -> bytes:
        if pt is None:
            return bytes(2 * self.n8q)
        return self.fq(pt[0].v) + self.fq(pt[1].v)

    def g2(self, pt) -> bytes:
        if pt is None:
            return bytes(4 * self.n8q)
        return (self.fq(pt[0].c0.v) + self.fq(pt[0].c1.v)
                + self.fq(pt[1].c0.v) + self.fq(pt[1].c1.v))


def groth16_setup(r1cs: R1CS, seed: bytes | None = None):
    """-> (zkey_bytes, vk_dict). vk_dict feeds snark/groth16_verify directly.

    seed: derive the toxic waste deterministically (tests); None = OS
    entropy. Either way tau/alpha/... only live inside this call frame.
    """
    curve = r1cs.curve
    p = curve.fr.p
    rng = (lambda: int.from_bytes(secrets.token_bytes(48), "little") % p)
    if seed is not None:
        import hashlib

        ctr = [0]

        def rng():  # noqa: F811
            ctr[0] += 1
            return int.from_bytes(
                hashlib.sha512(seed + ctr[0].to_bytes(4, "little")).digest(),
                "little") % p

    tau, alpha, beta, gamma, delta = (rng() for _ in range(5))

    n_public = r1cs.n_pub_in + r1cs.n_pub_out
    n_vars = r1cs.n_wires
    nc = r1cs.n_constraints
    total_rows = nc + n_public + 1
    domain = 1
    while domain < total_rows:
        domain <<= 1
    logn = domain.bit_length() - 1

    # ---- Lagrange evaluations at tau over the domain and the coset ----
    omega = curve.fr.root_of_unity(logn)
    g = curve.fr.groth16_coset_root(logn)
    tau_g = tau * pow(g, -1, p) % p
    zt = (pow(tau, domain, p) - 1) % p
    zt_coset = (pow(tau_g, domain, p) - 1) % p  # Z(tau/g)*... see below
    if zt == 0 or zt_coset == 0:
        raise ValueError("tau landed in the evaluation domain; re-sample")
    omegas = [1] * domain
    for i in range(1, domain):
        omegas[i] = omegas[i - 1] * omega % p
    n_inv = pow(domain, -1, p)
    # L_i(y) = omega^i * (y^n - 1) / (n * (y - omega^i))
    den = _batch_inv([(tau - w) % p for w in omegas], p)
    lag_tau = [omegas[i] * zt % p * n_inv % p * den[i] % p
               for i in range(domain)]
    den_c = _batch_inv([(tau_g - w) % p for w in omegas], p)
    lag_coset = [omegas[i] * zt_coset % p * n_inv % p * den_c[i] % p
                 for i in range(domain)]

    # ---- QAP evaluations a_j(tau), b_j(tau), c_j(tau) ----
    a_t = [0] * n_vars
    b_t = [0] * n_vars
    c_t = [0] * n_vars
    coeff_entries = []  # (matrix, row, signal, value) for section 4
    for row, (A, B, C) in enumerate(r1cs.constraints):
        for sig, v in A:
            a_t[sig] = (a_t[sig] + v * lag_tau[row]) % p
            coeff_entries.append((0, row, sig, v % p))
        for sig, v in B:
            b_t[sig] = (b_t[sig] + v * lag_tau[row]) % p
            coeff_entries.append((1, row, sig, v % p))
        for sig, v in C:
            c_t[sig] = (c_t[sig] + v * lag_tau[row]) % p
    # instance-binding rows (snarkjs): A[nc + j][j] = 1 for j = 0..n_public
    for j in range(n_public + 1):
        a_t[j] = (a_t[j] + lag_tau[nc + j]) % p
        coeff_entries.append((0, nc + j, j, 1))

    # ---- queries ----
    g1 = _g1(curve)
    g2 = _g2(curve)

    def m1(s):
        s %= p
        return None if s == 0 else ec_mul(g1, s)

    def m2(s):
        s %= p
        return None if s == 0 else ec_mul(g2, s)

    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)
    ic = [m1((beta * a_t[j] + alpha * b_t[j] + c_t[j]) * gamma_inv)
          for j in range(n_public + 1)]
    l_query = [m1((beta * a_t[j] + alpha * b_t[j] + c_t[j]) * delta_inv)
               for j in range(n_public + 1, n_vars)]
    a_query = [m1(a_t[j]) for j in range(n_vars)]
    b1_query = [m1(b_t[j]) for j in range(n_vars)]
    b2_query = [m2(b_t[j]) for j in range(n_vars)]
    # h_query: coset-Lagrange basis (see module docstring)
    zc = (pow(g, domain, p) - 1) % p  # Z on the coset is this constant
    h_scale = zt * pow(zc, -1, p) % p * delta_inv % p
    h_query = [m1(lag_coset[i] * h_scale) for i in range(domain)]

    alpha_g1 = m1(alpha)
    beta_g1 = m1(beta)
    beta_g2 = m2(beta)
    gamma_g2 = m2(gamma)
    delta_g1 = m1(delta)
    delta_g2 = m2(delta)

    # ---- serialize ----
    enc = _ZkeyEnc(curve)
    hdr = b"".join([
        struct.pack("<I", enc.n8q), curve.fq.p.to_bytes(enc.n8q, "little"),
        struct.pack("<I", enc.n8r), curve.fr.p.to_bytes(enc.n8r, "little"),
        struct.pack("<III", n_vars, n_public, domain),
        enc.g1(alpha_g1), enc.g1(beta_g1), enc.g2(beta_g2),
        enc.g2(gamma_g2), enc.g1(delta_g1), enc.g2(delta_g2),
    ])
    coeffs = [struct.pack("<I", len(coeff_entries))]
    for m, row, sig, v in coeff_entries:
        coeffs.append(struct.pack("<III", m, row, sig) + enc.fr2(v))
    sections = [
        (1, struct.pack("<I", 1)),
        (2, hdr),
        (3, b"".join(enc.g1(pt) for pt in ic)),
        (4, b"".join(coeffs)),
        (5, b"".join(enc.g1(pt) for pt in a_query)),
        (6, b"".join(enc.g1(pt) for pt in b1_query)),
        (7, b"".join(enc.g2(pt) for pt in b2_query)),
        (8, b"".join(enc.g1(pt) for pt in l_query)),
        (9, b"".join(enc.g1(pt) for pt in h_query)),
    ]
    zkey_bytes = write_binfile("zkey", 1, sections)

    vk = {
        "curve": curve,
        "n_public": n_public,
        "alpha_1": _g1_ints(alpha_g1),
        "beta_2": _g2_ints(beta_g2),
        "gamma_2": _g2_ints(gamma_g2),
        "delta_2": _g2_ints(delta_g2),
        "ic": [_g1_ints(pt) for pt in ic],
    }
    return zkey_bytes, vk
