"""Port vs JAX package: prime-field arithmetic (kernel K1's plain version).

Tolerance 0.  The JAX side runs its Pallas kernel in interpret mode and its
XLA path; the port runs `mont_mul_plain` and the plain add/sub on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocircom_tpu.fields.params import BN254
from cocircom_tpu.ops.field import get_field as ref_get_field
from cocircom_tpu.ops.pallas_field import mont_mul_pallas
from cocircom_tpu_torch.ops.field import (get_field, mont_mul_plain, pack16_to_32,
                                          unpack32_to_16)
from torch_port_util import rand_ints, same, to_port

FIELDS = [(BN254.fr.p, "bn254.fr"), (BN254.fq.p, "bn254.fq")]


def test_repack_round_trip():
    rng = np.random.default_rng(0)
    x16 = rng.integers(0, 1 << 16, size=(16, 5, 7), dtype=np.uint32)
    x32 = pack16_to_32(torch.from_numpy(x16.astype(np.int64)))
    assert x32.dtype == torch.int32 and tuple(x32.shape) == (8, 5, 7)
    back = unpack32_to_16(x32).numpy().astype(np.uint32)
    assert np.array_equal(back, x16)
    # limb pairing, no arithmetic: word k = limb 2k | limb 2k+1 << 16
    want = x16[0::2].astype(np.uint64) | (x16[1::2].astype(np.uint64) << 16)
    assert np.array_equal(x32.numpy().view(np.uint32), want.astype(np.uint32))


@pytest.mark.parametrize("p,name", FIELDS)
def test_mont_mul_plain_matches_pallas_and_ints(p, name):
    rf = ref_get_field(p, name)
    f = get_field(p, name, device="cpu")
    edge = [0, 1, p - 1, 2, p - 2]
    va = edge + rand_ints(p, 120, 1)
    vb = edge[::-1] + rand_ints(p, 120, 2)
    a16 = jnp.asarray(rf.to_limbs(va))
    b16 = jnp.asarray(rf.to_limbs(vb))
    ref = mont_mul_pallas(rf, a16, b16, interpret=True)
    got = mont_mul_plain(f, to_port(a16), to_port(b16))
    assert same(got, ref)
    assert same(got, rf.mont_mul(a16, b16))
    r_inv = pow(f.R, -1, p)
    assert list(f.from_limbs(got)) == [x * y * r_inv % p for x, y in zip(va, vb)]


def test_mont_mul_broadcast_single_operand():
    p, name = FIELDS[0]
    rf = ref_get_field(p, name)
    f = get_field(p, name, device="cpu")
    a16 = jnp.asarray(rf.to_limbs(list(range(1, 61)))).reshape(rf.L, 3, 20)
    b16 = a16[:, :1, :1]
    ref = mont_mul_pallas(rf, a16, b16, interpret=True)
    assert same(f.mont_mul(to_port(a16), to_port(b16)), ref)


@pytest.mark.parametrize("p,name", FIELDS)
def test_add_sub_neg_match(p, name):
    rf = ref_get_field(p, name)
    f = get_field(p, name, device="cpu")
    va = [0, 0, p - 1, p - 1, 1] + rand_ints(p, 60, 3)
    vb = [0, p - 1, p - 1, 1, p - 1] + rand_ints(p, 60, 4)
    a16, b16 = jnp.asarray(rf.to_limbs(va)), jnp.asarray(rf.to_limbs(vb))
    a, b = to_port(a16), to_port(b16)
    assert same(f.add(a, b), rf.add(a16, b16))
    assert same(f.sub(a, b), rf.sub(a16, b16))
    assert same(f.neg(a), rf.neg(a16))
    assert same(f.double(a), rf.double(a16))


def test_encode_decode_and_batch_inv_match():
    p, name = FIELDS[0]
    rf = ref_get_field(p, name)
    f = get_field(p, name, device="cpu")
    vals = [0, 1, p - 1] + rand_ints(p, 10, 5)
    enc_ref = rf.encode(vals)
    enc = f.encode(vals)
    assert same(enc, enc_ref)
    assert [int(v) for v in f.decode(enc)] == vals
    assert same(f.batch_inv(enc), rf.batch_inv(enc_ref))
    assert same(f.inv(enc[:, 3:5]), rf.inv(enc_ref[:, 3:5]))
    assert same(f.sum(enc), rf.sum(enc_ref))
    assert same(f.from_mont(enc), rf.from_mont(enc_ref))


def test_bytes_load_by_reinterpretation():
    p, name = FIELDS[1]
    rf = ref_get_field(p, name)
    f = get_field(p, name, device="cpu")
    rng = np.random.default_rng(6)
    data = rng.bytes(32 * 9)
    assert same(f.bytes_to_limbs(data, 9), rf.bytes_to_limbs(data, 9))
    assert f.limbs_to_bytes(f.bytes_to_limbs(data, 9)) == data
