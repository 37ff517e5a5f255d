"""Port vs JAX package: NTT (kernels K2 and K3's plain versions), tolerance 0.

The JAX side runs `butterfly_pallas` and `fourstep_ntt` in interpret mode
and its per-stage engine; the port runs `butterfly_plain`, the per-stage
path and the four-step path over `ntt_columns_plain` on the CPU.
"""

import numpy as np
import pytest

from cocircom_tpu.fields.params import BN254
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.ops.ntt import ntt_engine as ref_ntt_engine
from cocircom_tpu.ops.pallas_field import butterfly_pallas
from cocircom_tpu.ops.pallas_ntt import build_aux, fourstep_ntt
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.ops.field import get_field
from cocircom_tpu_torch.ops.ntt import NTTEngine, butterfly_plain, ntt_engine
from torch_port_util import rand_ints, same, to_port

P = BN254.fr.p
rf = ref_get_field(P, "bn254.fr")
reng = ref_ntt_engine(rf, BN254.fr)


def _port():
    f = get_field(P, "bn254.fr", device="cpu")
    return f, ntt_engine(f, PBN254.fr)


def test_butterfly_plain_matches_pallas():
    f, _ = _port()
    n = 200
    e, o, w = (rf.encode([0, 1, P - 1] + rand_ints(P, n - 3, s)) for s in (1, 2, 3))
    re, ro = butterfly_pallas(rf, e, o, w, interpret=True)
    ge, go = butterfly_plain(f, to_port(e), to_port(o), to_port(w))
    assert same(ge, re) and same(go, ro)


@pytest.mark.parametrize("logn", [3, 6])
@pytest.mark.parametrize("inverse", [False, True])
def test_per_stage_matches_engine(logn, inverse):
    f, eng = _port()
    a = rf.encode(rand_ints(P, 1 << logn, 10 + logn))
    reng._warm(logn, inverse)
    want = reng._ntt(a, logn, inverse)
    got = (eng.intt if inverse else eng.ntt)(to_port(a))
    assert same(got, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_2p12_matches_pallas_and_engine(inverse):
    """2^12 points through the four-step path with 2^4-point column
    transforms (three recursion levels), against the JAX package's four-step
    kernel in interpret mode and its per-stage engine."""
    f, _ = _port()
    eng = NTTEngine(f, PBN254.fr)
    eng.KMAX = 4
    logn, n = 12, 1 << 12
    a = rf.encode(rand_ints(P, n, 20 + inverse))
    got = (eng.intt if inverse else eng.ntt)(to_port(a))
    aux = build_aux(rf, BN254.fr, logn, inverse, kmax=4)
    ref4 = fourstep_ntt(rf, a[:, :, None], logn, aux, interpret=True, kmax=4)
    assert same(got, np.asarray(ref4).reshape(rf.L, n))
    reng._warm(logn, inverse)
    assert same(got, reng._ntt(a, logn, inverse))


def test_fourstep_equals_per_stage_in_port():
    f, eng = _port()
    four = NTTEngine(f, PBN254.fr)
    four.FOURSTEP_MIN_LOG, four.KMAX = 5, 3
    a = to_port(rf.encode(rand_ints(P, 1 << 7, 30)))
    assert bool((four.ntt(a) == eng.ntt(a)).all())
    assert bool((four.intt(four.ntt(a)) == a).all())


def test_coset_shift_matches():
    f, eng = _port()
    a = rf.encode(rand_ints(P, 64, 40))
    assert same(eng.coset_shift(to_port(a)), reng.coset_shift(a))
    assert same(eng.coset_shift(to_port(a), 5), reng.coset_shift(a, 5))
