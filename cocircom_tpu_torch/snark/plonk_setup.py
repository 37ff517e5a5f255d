"""PLONK trusted setup + snarkjs .zkey writer (`snarkjs plonk setup`
equivalent).

Plonkization follows snarkjs plonk_setup.js: every R1CS constraint
(sum_A)(sum_B) = (sum_C) has each side reduced to at most one signal via
"addition" wires (id = f1*w[id1] + f2*w[id2], recorded in the additions
section — the PROVER recomputes their values, snark/plonk.py), then one
multiplication gate
    qm*a*b + ql*a + qr*b + qo*c + qc = 0
with qm = cA*cB, ql = cA*kB, qr = kA*cB, qo = -cC, qc = kA*kB - kC.
Constant-only sides reduce to (signal 0, coef 0) so the same formula
covers them. Public inputs get one leading gate each: ql = 1 (the prover
adds PI(z) = -sum pub_i L_i(z)). Sigma is the standard 3-column cycle
permutation over (w^i, k1 w^i, k2 w^i) with k1 = 2, k2 = 3.

Output is byte-compatible with io/plonk_zkey.read_plonk_zkey (the snarkjs
layout: sections 1 prover-type=2, 2 header+vk, 3 additions, 4/5/6 wire
maps, 7..11 selectors, 12 sigmas, 13 public lagranges, 14 p_tau). Like
snark/setup.py this is a SINGLE-PARTY setup (the runner sees tau).
"""

from __future__ import annotations

import secrets
import struct

from ..fields.ec_host import ec_mul
from ..io.binfile import write_binfile
from ..io.r1cs import R1CS
from .setup import _ZkeyEnc, _g1, _g2, _g1_ints, _g2_ints


def _host_fft(vals: list[int], root: int, p: int) -> list[int]:
    """In-order radix-2 Cooley-Tukey over Fr (host ints)."""
    n = len(vals)
    if n == 1:
        return list(vals)
    a = list(vals)
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    size = 2
    while size <= n:
        step = pow(root, n // size, p)
        for start in range(0, n, size):
            w = 1
            for k in range(start, start + size // 2):
                u, v = a[k], a[k + size // 2] * w % p
                a[k] = (u + v) % p
                a[k + size // 2] = (u - v) % p
                w = w * step % p
        size <<= 1
    return a


def _host_ifft(vals: list[int], root: int, p: int) -> list[int]:
    n = len(vals)
    inv_root = pow(root, -1, p)
    out = _host_fft(vals, inv_root, p)
    n_inv = pow(n, -1, p)
    return [v * n_inv % p for v in out]


def plonk_setup(r1cs: R1CS, seed: bytes | None = None):
    """-> (zkey_bytes, vk_dict). vk_dict matches io/jsonio.parse_plonk_vk."""
    curve = r1cs.curve
    p = curve.fr.p
    if seed is not None:
        import hashlib

        tau = int.from_bytes(hashlib.sha512(seed + b"plonk").digest(),
                             "little") % p
    else:
        tau = int.from_bytes(secrets.token_bytes(48), "little") % p

    n_public = r1cs.n_pub_in + r1cs.n_pub_out
    n_wires = r1cs.n_wires
    k1, k2 = 2, 3

    # ---- plonkization ----
    additions: list[tuple[int, int, int, int]] = []  # (id1, id2, f1, f2)
    gates: list[list[int]] = []  # [a, b, c, qm, ql, qr, qo, qc]
    n_vars = [n_wires]

    def reduce_coefs(lc, max_c):
        k = 0
        cs = []
        for sig, coef in lc:
            coef %= p
            if coef == 0:
                continue
            if sig == 0:
                k = (k + coef) % p
            else:
                cs.append((sig, coef))
        while len(cs) > max_c:
            (s1, c1) = cs.pop()
            (s2, c2) = cs.pop()
            sl = n_vars[0]
            n_vars[0] += 1
            additions.append((s1, s2, c1, c2))
            cs.append((sl, 1))
        while len(cs) < max_c:
            cs.append((0, 0))
        return k, cs

    for i in range(1, n_public + 1):
        gates.append([i, 0, 0, 0, 1, 0, 0, 0])

    for A, B, C in r1cs.constraints:
        ka, sa = reduce_coefs(A, 1)
        kb, sb = reduce_coefs(B, 1)
        kc, sc = reduce_coefs(C, 1)
        (a_s, a_c), (b_s, b_c), (c_s, c_c) = sa[0], sb[0], sc[0]
        gates.append([
            a_s, b_s, c_s,
            a_c * b_c % p,
            a_c * kb % p,
            ka * b_c % p,
            (-c_c) % p,
            (ka * kb - kc) % p,
        ])

    n_constraints = len(gates)
    pow2 = 3  # snarkjs minimum domain 2^3
    while (1 << pow2) < n_constraints:
        pow2 += 1
    domain = 1 << pow2
    omega = curve.fr.root_of_unity(pow2)
    if pow(tau, domain, p) == 1:
        raise ValueError("tau landed in the evaluation domain; re-sample")

    # ---- sigma permutation over 3*domain slots ----
    ident = [0] * (3 * domain)
    w = 1
    for i in range(domain):
        ident[i] = w
        ident[domain + i] = k1 * w % p
        ident[2 * domain + i] = k2 * w % p
        w = w * omega % p
    sigma = list(ident)
    first_pos: dict[int, int] = {}
    last_pos: dict[int, int] = {}

    # snarkjs orientation (recovered from the committed multiplier2 zkey):
    # sigma(pos) = id(PREVIOUS occurrence of the signal in row-major a,b,c
    # scan order); the first occurrence closes the cycle with id(last).
    def build_sigma(s, pos):
        if s in last_pos:
            sigma[pos] = ident[last_pos[s]]
        else:
            first_pos[s] = pos
        last_pos[s] = pos

    for row in range(domain):  # padding rows scan signal 0 in every slot
        g = gates[row] if row < len(gates) else (0, 0, 0)
        build_sigma(g[0], row)
        build_sigma(g[1], domain + row)
        build_sigma(g[2], 2 * domain + row)
    for s, fp in first_pos.items():
        sigma[fp] = ident[last_pos[s]]

    # ---- polynomials (coeffs + 4n extended evals) ----
    def poly_bytes(evals_on_domain, enc):
        coeffs = _host_ifft(evals_on_domain, omega, p)
        omega4 = curve.fr.root_of_unity(pow2 + 2)
        ext = _host_fft(coeffs + [0] * (3 * domain), omega4, p)
        return b"".join(enc.frm(v) for v in coeffs) + b"".join(
            enc.frm(v) for v in ext)

    enc = _ZkeyEnc(curve)
    enc.frm = lambda v: (v % p * enc.Rr % p).to_bytes(enc.n8r, "little")

    sel = {name: [0] * domain for name in ("qm", "ql", "qr", "qo", "qc")}
    for row, g in enumerate(gates):
        sel["qm"][row], sel["ql"][row], sel["qr"][row] = g[3], g[4], g[5]
        sel["qo"][row], sel["qc"][row] = g[6], g[7]

    s_cols = [sigma[0:domain], sigma[domain:2 * domain], sigma[2 * domain:]]
    lagranges = []
    for i in range(n_public):
        ev = [0] * domain
        ev[i] = 1
        lagranges.append(ev)

    # ---- commitments (known tau: commit = poly(tau)*G1) ----
    g1 = _g1(curve)
    g2 = _g2(curve)

    def commit_evals(evals_on_domain):
        coeffs = _host_ifft(evals_on_domain, omega, p)
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * tau + c) % p
        return None if acc == 0 else ec_mul(g1, acc)

    qm_c = commit_evals(sel["qm"])
    ql_c = commit_evals(sel["ql"])
    qr_c = commit_evals(sel["qr"])
    qo_c = commit_evals(sel["qo"])
    qc_c = commit_evals(sel["qc"])
    s1_c = commit_evals(s_cols[0])
    s2_c = commit_evals(s_cols[1])
    s3_c = commit_evals(s_cols[2])
    x_2 = ec_mul(g2, tau)

    # p_tau: tau^i * G1, i < domain + 6
    p_tau_pts = []
    acc = 1
    for _ in range(domain + 6):
        p_tau_pts.append(ec_mul(g1, acc) if acc else None)
        acc = acc * tau % p

    # ---- serialize ----
    hdr = b"".join([
        struct.pack("<I", enc.n8q), curve.fq.p.to_bytes(enc.n8q, "little"),
        struct.pack("<I", enc.n8r), curve.fr.p.to_bytes(enc.n8r, "little"),
        struct.pack("<IIIII", n_vars[0], n_public, domain, len(additions),
                    n_constraints),
        enc.frm(k1), enc.frm(k2),
        enc.g1(qm_c), enc.g1(ql_c), enc.g1(qr_c), enc.g1(qo_c), enc.g1(qc_c),
        enc.g1(s1_c), enc.g1(s2_c), enc.g1(s3_c), enc.g2(x_2),
    ])
    adds = b"".join(
        struct.pack("<II", id1, id2) + enc.frm(f1) + enc.frm(f2)
        for id1, id2, f1, f2 in additions)
    maps = [
        b"".join(struct.pack("<I", g[slot]) for g in gates)
        for slot in (0, 1, 2)
    ]
    sections = [
        (1, struct.pack("<I", 2)),
        (2, hdr),
        (3, adds),
        (4, maps[0]),
        (5, maps[1]),
        (6, maps[2]),
        (7, poly_bytes(sel["qm"], enc)),
        (8, poly_bytes(sel["ql"], enc)),
        (9, poly_bytes(sel["qr"], enc)),
        (10, poly_bytes(sel["qo"], enc)),
        (11, poly_bytes(sel["qc"], enc)),
        (12, b"".join(poly_bytes(c, enc) for c in s_cols)),
        (13, b"".join(poly_bytes(lv, enc) for lv in lagranges)),
        (14, b"".join(enc.g1(pt) for pt in p_tau_pts)),
    ]
    zkey_bytes = write_binfile("zkey", 1, sections)

    vk = {
        "curve": curve,
        "n_public": n_public,
        "power": pow2,
        "k1": k1,
        "k2": k2,
        "qm": _g1_ints(qm_c),
        "ql": _g1_ints(ql_c),
        "qr": _g1_ints(qr_c),
        "qo": _g1_ints(qo_c),
        "qc": _g1_ints(qc_c),
        "s1": _g1_ints(s1_c),
        "s2": _g1_ints(s2_c),
        "s3": _g1_ints(s3_c),
        "x_2": _g2_ints(x_2),
    }
    return zkey_bytes, vk
