"""The plain reference of the Groth16 cells: host Python integers and numpy
object arrays, nothing of the program.

The synthetic zkey's points are known multiples k_i of their generators
(alpha, beta, gamma, delta = 3, 5, 7, 11), so every multi-scalar product of
the proof is known as a discrete log.  What the proof's blinding r and s
hide, a pairing removes.  With z = [1, x, w] and

    a0 = alpha + sum z_i kA_i      b0 = beta + sum z_i kB1_i
    b0' = beta + sum z_i kB2_i     l = sum w_k kL_k      h = sum h_j kH_j,

where h_j = A(g w^j) B(g w^j) - C(g w^j) are the witness map's values on
the coset (A, B, C interpolating the constraint rows on the domain), an
honest proof is A = (a0 + r delta) G1, B = (b0' + s delta) G2 and
C = s A + (r b0 + l + h) G1.  So with R = delta^-1 (A - a0 G1) = r G1 and
S = delta^-1 (B - b0' G2) = s G2,

    e(C - (l + h) G1 - b0 R, G2) = e(A, S),

which holds for an honest proof whatever r and s are, and fails for any
other C.  `check_proof` tests that equation on the host, `check_proofs`
many proofs in worker processes.  The witness map and the sums that make the
scalars run on the card in plain PyTorch (`DeviceWitnessMap`, over
`fr_torch`), so that every proof of a window can be checked; `witness_map`,
the same over numpy object arrays, is the small-size oracle it is tested
against.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

import numpy as np

from .fr_torch import Field, bit_reverse
from .host.fields.ec_host import ec_add, ec_mul, ec_neg
from .host.fields.params import BN254
from .host.pairing.pairing import engine
from .host.pairing.tower import Tower

P = BN254.fr.p
ALPHA, BETA, DELTA = 3, 5, 11     # gamma (7) is not in the equation
PAIRING_WORKERS = 6       # processes that check proofs' pairing equations


# ------------------------------------------------------------------ field

def snarkjs_roots(p: int = P) -> tuple[int, list]:
    """(smallest quadratic non-residue q, [w_0 .. w_s]) with w_k a primitive
    2^k-th root of unity, w_s = q^((p-1) / 2^s): snarkjs's convention."""
    s, t = 0, p - 1
    while t % 2 == 0:
        s, t = s + 1, t // 2
    q = 2
    while pow(q, (p - 1) // 2, p) != p - 1:
        q += 1
    roots = [pow(q, t, p)]
    for _ in range(s):
        roots.append(roots[-1] * roots[-1] % p)
    return q, roots[::-1]


def coset_root(log_n: int, p: int = P) -> int:
    """The coset generator of a 2^log_n domain: the 2^(log_n+1)-th root."""
    q, roots = snarkjs_roots(p)
    return q * q % p if log_n == len(roots) - 1 else roots[log_n + 1]


def powers(g: int, n: int, p: int = P) -> np.ndarray:
    """[1, g, ..., g^(n-1)] as an object array, by doubling."""
    t = np.array([1], dtype=object)
    while len(t) < n:
        t = np.concatenate([t, t * pow(g, len(t), p) % p])
    return t[:n]


def ntt(x: np.ndarray, w: int, p: int = P) -> np.ndarray:
    """y_j = sum_i x_i w^(ij) for n = len(x) a power of two, natural order in
    and out (radix-2, decimation in time)."""
    n = len(x)
    a = np.asarray(x, dtype=object)[bit_reverse(n)]
    table = powers(w, max(n // 2, 1), p)
    m = 1
    while m < n:
        a = a.reshape(-1, 2 * m)
        t = a[:, m:] * table[:: n // (2 * m)] % p
        u = a[:, :m]
        a = np.concatenate([(u + t) % p, (u - t) % p], axis=1)
        m *= 2
    return a.reshape(n)


def to_coset(v: np.ndarray, log_n: int, p: int = P) -> np.ndarray:
    """The values on the domain g w^j of the polynomial that takes the
    values v on the domain w^j: iNTT, times g^i, NTT."""
    n = 1 << log_n
    _, roots = snarkjs_roots(p)
    w = roots[log_n]
    coeffs = ntt(v, pow(w, p - 2, p), p) * pow(n, p - 2, p) % p
    return ntt(coeffs * powers(coset_root(log_n, p), n, p) % p, w, p)


def dot(a: np.ndarray, k: np.ndarray, p: int = P) -> int:
    """sum a_i k_i mod p for object ints a and small int multipliers k."""
    return int(np.dot(a, np.asarray(k, dtype=np.int64).astype(object))) % p


# ------------------------------------------------------------ witness map

def witness_map(z: np.ndarray, n_public: int, nc: int, log_n: int) -> np.ndarray:
    """h on the coset for the synthetic circuit: row j < nc of A takes
    z[(7j + 1) mod n], of B z[(13j + 3) mod n]; rows nc .. nc + n_public of
    A hold the public inputs [1, x]; C = A B on the domain."""
    n = 1 << log_n
    j = np.arange(nc)
    a = np.zeros(n, dtype=object)
    b = np.zeros(n, dtype=object)
    a[:nc] = z[(7 * j + 1) % n]
    b[:nc] = z[(13 * j + 3) % n]
    a[nc:nc + n_public + 1] = z[:n_public + 1]
    c = a * b % P
    ac, bc, cc = (to_coset(v, log_n) for v in (a, b, c))
    return (ac * bc - cc) % P


class DeviceWitnessMap:
    """`witness_map` in plain PyTorch on (16, n) limbs (`fr_torch`), its
    twiddles made once for the domain."""

    def __init__(self, log_n: int, device):
        f = self.f = Field(P, device)
        n = self.n = 1 << log_n
        _, roots = snarkjs_roots()
        w = roots[log_n]
        self.fwd = f.powers(w, n // 2)
        self.inv = f.powers(pow(w, P - 2, P), n // 2)
        self.shift = f.mul(f.powers(coset_root(log_n), n), f.const(pow(n, P - 2, P)))

    def to_coset(self, v):
        """Montgomery values on the domain -> on the coset."""
        f = self.f
        return f.ntt(f.mul(f.ntt(v, self.inv), self.shift), self.fwd)

    def __call__(self, z, n_public: int, nc: int):
        """h on the coset, plain (16, n) limbs, of z = [1, x, w] as plain
        (16, n_vars) limbs."""
        torch, f, n = self.f.torch, self.f, self.n
        j = torch.arange(nc, device=z.device)
        a = torch.zeros((z.shape[0], n), dtype=torch.int64, device=z.device)
        b = torch.zeros_like(a)
        a[:, :nc] = z[:, (7 * j + 1) % n]
        b[:, :nc] = z[:, (13 * j + 3) % n]
        a[:, nc:nc + n_public + 1] = z[:, :n_public + 1]
        a, b = f.to_mont(a), f.to_mont(b)
        c = f.mul(a, b)
        ac, bc, cc = (self.to_coset(v) for v in (a, b, c))
        return f.from_mont(f.sub(f.mul(ac, bc), cc))

    def scalars(self, z, h, mult: dict) -> dict:
        """`scalars` from plain limbs z = [1, x, w] and h."""
        f = self.f
        return {"a0": (ALPHA + f.dot_small(z, mult["a"])) % P,
                "b0": (BETA + f.dot_small(z, mult["b1"])) % P,
                "b0g2": (BETA + f.dot_small(z, mult["b2"])) % P,
                "lh": (f.dot_small(z[:, 2:], mult["l"]) + f.dot_small(h, mult["h"])) % P}


# ------------------------------------------------------------------ check

class Curves:
    """The host tower's generators and the pairing engine of BN254."""

    def __init__(self):
        t = Tower(BN254)
        self.t = t
        self.g1 = (t.fp(BN254.g1_gen[0]), t.fp(BN254.g1_gen[1]))
        (x0, x1), (y0, y1) = BN254.g2_gen
        self.g2 = (t.fp2(x0, x1), t.fp2(y0, y1))
        self.pairing = engine(BN254)

    def pt1(self, xy):
        return None if xy is None else (self.t.fp(xy[0]), self.t.fp(xy[1]))

    def pt2(self, xy):
        return None if xy is None else (self.t.fp2(*xy[0]), self.t.fp2(*xy[1]))


def _ints1(pt):
    return None if pt is None else (pt[0].v, pt[1].v)


def _ints2(pt):
    return None if pt is None else ((pt[0].c0.v, pt[0].c1.v), (pt[1].c0.v, pt[1].c1.v))


def scalars(z: np.ndarray, mult: dict, h: np.ndarray) -> dict:
    """The discrete logs the proof is built from (module docstring)."""
    w = z[2:]
    return {"a0": (ALPHA + dot(z, mult["a"])) % P, "b0": (BETA + dot(z, mult["b1"])) % P,
            "b0g2": (BETA + dot(z, mult["b2"])) % P,
            "lh": (dot(w, mult["l"]) + dot(h, mult["h"])) % P}


def check_proof(proof: dict, s: dict, curves: Curves | None = None) -> bool:
    """Whether (pi_a, pi_b, pi_c), affine integer coordinates, satisfy
    e(C - (l + h) G1 - b0 R, G2) = e(A, S) (module docstring)."""
    cv = curves or Curves()
    a, b, c = cv.pt1(proof["pi_a"]), cv.pt2(proof["pi_b"]), cv.pt1(proof["pi_c"])
    if a is None or b is None or c is None:
        return False
    dinv = pow(DELTA, P - 2, P)
    r1 = ec_mul(ec_add(a, ec_neg(ec_mul(cv.g1, s["a0"]))), dinv)
    s2 = ec_mul(ec_add(b, ec_neg(ec_mul(cv.g2, s["b0g2"]))), dinv)
    lhs = ec_add(ec_add(c, ec_neg(ec_mul(cv.g1, s["lh"]))), ec_neg(ec_mul(r1, s["b0"])))
    return cv.pairing.pairing_check([(_ints1(lhs), _ints2(cv.g2)),
                                     (_ints1(ec_neg(a)), _ints2(s2))])


def _check_one(item) -> bool:
    return check_proof(*item)


def check_proofs(items: list, workers: int = PAIRING_WORKERS) -> list:
    """[check_proof(proof, scalars) for (proof, scalars) in items], in up to
    `workers` processes where there is more than one item."""
    workers = min(workers, len(items), os.cpu_count() or 1)
    if workers <= 1:
        return [_check_one(it) for it in items]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        return list(ex.map(_check_one, items))
