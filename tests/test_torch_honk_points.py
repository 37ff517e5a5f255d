"""co-UltraHonk over a setup of points alone (honk/crs.py PointCrs): every
commitment an MSM over the shares, the KZG quotient computed as
coefficients on the shares.

The co-prover hands every commitment to its setup (`commit_shares`,
`commit_opening`); nothing else differs between a setup of points and the
known-tau TestCrs.  The whole co-proof over a PointCrs, against the JAX
package's pinned plain proof of the 16-gate squaring chain, is the noir
CLI's `--crs file` round trip under REP3 (tests/test_torch_co_honk.py).
Under Shamir, here, a PointCrs made from TestCrs's tau commits shared
polynomials and a KZG quotient to the points TestCrs commits them to, and
those are the host's commitments; the Shamir co-proof over TestCrs is
held to the pin in tests/test_torch_co_honk.py.  A co-proof over a setup
of points costs one to two minutes on the CPU (its seven MSM engine calls
a party in the plain versions), so Tier-1 holds one.
"""

import random

import pytest

from cocircom_tpu_torch.fields.params import BN254
from cocircom_tpu_torch.honk.builder import P
from cocircom_tpu_torch.honk.co_prover import opening_quotient
from cocircom_tpu_torch.honk.crs import (PointCrs, TestCrs, generate_test_setup_g1, write_g1_dat,
                                         write_g2_dat)
from cocircom_tpu_torch.honk.zeromorph import compute_opening_proof
from cocircom_tpu_torch.mpc.driver import PlainDriver
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.mpc.shamir import ShamirDriver, share_field_vec_shamir
from cocircom_tpu_torch.ops.field import get_field
from torch_port_util import small_msm_engines

FR = get_field(P, "bn254.fr", device="cpu")
SETUP = 64   # points: more than the 16-gate chain's circuit size


@pytest.fixture(scope="module")
def setup():
    crs = PointCrs.from_tau(TestCrs().tau, SETUP, "cpu")
    assert not hasattr(crs, "tau")
    return crs


@pytest.fixture
def small_msm(monkeypatch):
    """MSM engines with a rank split of 2: the bucket reduction of a toy
    MSM is most of its time on the CPU."""
    restore = small_msm_engines(monkeypatch)
    yield
    restore()


def _host(pts) -> list:
    """Host points (a pair of ints or of Fp, or None) as pairs of ints."""
    return [None if p is None else tuple(int(getattr(c, "v", c)) for c in p) for p in pts]


def test_shamir_point_setup_commits_shares_as_the_known_tau_setup(setup, small_msm):
    """Shamir parties (n = 3, t = 1): PointCrs's commitments to three
    shared polynomials (one MSM engine call over the shares, then
    open_point) are TestCrs's (local evaluations at tau) for the same tau,
    and the host's f(tau) G1; so is TestCrs's commitment to the KZG
    quotient of a shared pi with pi(x) = 0.  The setup holds no tau, so
    nothing on its route reads one.  (PointCrs.commit_opening is
    `opening_quotient`, tested below, then commit_shares: the REP3 co-proof
    of the CLI's round trip runs it.)"""
    rng = random.Random(64)
    n = 32
    x = rng.randrange(P)
    polys = [[rng.randrange(P) for _ in range(n)] for _ in range(3)]
    q = [rng.randrange(P) for _ in range(n - 1)]
    pi = ([(-x * q[0]) % P] + [(q[i - 1] - x * q[i]) % P for i in range(1, n - 1)]
          + [q[n - 2]])                                  # q (X - x)
    shares = [share_field_vec_shamir(FR, FR.encode(v), 1, 3, seed=64 + k, device="cpu")
              for k, v in enumerate(polys + [pi])]
    known = TestCrs()

    def party(i, net):
        d = ShamirDriver(BN254, net, threshold=1, device="cpu")
        mine = [s[i] for s in shares]
        return (_host(setup.commit_shares(d, mine[:3])), _host(known.commit_shares(d, mine[:3])),
                _host([known.commit_opening(d, mine[3], x)]))

    want = _host([known.commit(p) for p in polys]), _host([known.commit(q)])
    for got, got_known, w_known in run_parties(party, 3):
        assert got == got_known == want[0]
        assert w_known == want[1]


def test_point_setup_is_the_monomial_setup(setup, tmp_path):
    """PointCrs.from_tau makes [tau^i]G1 (the host's monomial setup) and
    tau G2; read back from .dat files written from it, it is the same."""
    tau = TestCrs().tau
    want = generate_test_setup_g1(8, tau)
    assert setup.points.x.shape[1] == SETUP
    assert setup.g1[0].v == 1 and setup.g1[1].v == 2
    got = PointCrs(setup.first(8), setup.g2_x)
    from cocircom_tpu_torch.ops.curve import g1_ops

    ops = g1_ops(BN254, "cpu")
    assert ops.decode_points(got.points) == want
    write_g1_dat(tmp_path / "g1.dat", want)
    write_g2_dat(tmp_path / "g2.dat", setup.g2_x)
    back = PointCrs.from_dat(tmp_path / "g1.dat", tmp_path / "g2.dat", 8, "cpu")
    assert not hasattr(back, "tau")
    assert ops.decode_points(back.points) == want
    assert back.g2_x == TestCrs().g2_x


@pytest.mark.parametrize("x", [0, 1, 5, None])
def test_shared_opening_quotient_equals_the_plain_division(x):
    """opening_quotient on shares (a plain driver) gives the coefficients
    compute_opening_proof divides out, for any pi (pi(x) need not be 0)
    and x = 0, 1, small and random."""
    rng = random.Random(63 if x is None else x)
    x = rng.randrange(P) if x is None else x
    pi = [rng.randrange(P) for _ in range(16)]
    want = []

    class Capture:
        def commit(self, q):
            want.append(list(q))

    class Sink:
        def send_point(self, label, pt):
            pass

    compute_opening_proof(pi, x, Capture(), Sink())
    d = PlainDriver(BN254, device="cpu")
    got = [int(v) for v in FR.decode(opening_quotient(d, FR.encode(pi), x))]
    assert got == want[0]
