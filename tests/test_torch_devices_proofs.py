"""The device-sharded path as a whole: a REP3 co-Groth16 proof and a Plain
proof whose drivers are built with `devices=` (every prover MSM and (i)NTT
through parallel/sharded.py) equal the one-device proof and verify.

A Groth16 proof is a function of the zkey, the witness and the two blinding
scalars r and s.  The REP3 parties' shares of r and s are recorded as they
are drawn; the one-device proof is the Plain driver's with `rand` pinned to
their sums, and so is the Plain proof through `devices=`: other drivers and
other engines must give the same three points.  The three proofs are made
once for the module.  tests/test_torch_groth16_rep3.py holds the one-device
REP3 proof equal to the JAX package's.
"""

import pytest
import torch

import cocircom_tpu_torch.mpc.driver as port_driver
import cocircom_tpu_torch.mpc.rep3 as port_rep3
from cocircom_tpu_torch.fields.params import BN254 as PBN254
from cocircom_tpu_torch.io.r1cs import multiplier_chain
from cocircom_tpu_torch.io.witness import Witness
from cocircom_tpu_torch.io.zkey import read_groth16_zkey
from cocircom_tpu_torch.mpc.runner import run_parties
from cocircom_tpu_torch.ops.field import ints_to_limbs_np
from cocircom_tpu_torch.parallel.sharded import ShardedMSMEngine, ShardedNTTEngine
from cocircom_tpu_torch.snark.groth16 import CoGroth16
from cocircom_tpu_torch.snark.groth16_verify import verify_groth16
from cocircom_tpu_torch.snark.setup import groth16_setup
from cocircom_tpu_torch.snark.shared import split_witness_plain, split_witness_rep3
from torch_port_util import small_msm_engines

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small_engines():
    with pytest.MonkeyPatch.context() as mp:
        restore = small_msm_engines(mp)
        yield
        restore()


@pytest.fixture(scope="module")
def circuit():
    r1cs, vals = multiplier_chain(PBN254, 12, 5)
    zkey_bytes, vk = groth16_setup(r1cs, seed=b"torch-port-sharded-rep3")
    zk = read_groth16_zkey(zkey_bytes, device=CPU)
    wit = Witness(PBN254, len(vals), ints_to_limbs_np(vals, 8))
    return zk, vk, wit, [vals[1], vals[2]]


@pytest.fixture(scope="module")
def rep3_sharded(small_engines, circuit):
    """(proof, party 0's engines, [r, s] as Montgomery elements) of a REP3
    proof whose three drivers shard over the CPU named twice."""
    zk, _, wit, _ = circuit
    shares = split_witness_rep3(wit, 2, seed=99, device=CPU)
    drawn = [[], [], []]          # each party's own shares of r and s, in order
    engines = []

    def party(i, net):
        d = port_rep3.Rep3Driver(PBN254, net, devices=[CPU] * 2)
        rand = d.rand

        def recording_rand(shape=()):
            share = rand(shape)
            drawn[i].append(share.a)
            return share

        d.rand = recording_rand
        if i == 0:
            engines.extend((d.msm_g1_engine, d.msm_g2_engine, d.ntt))
        return CoGroth16(d).prove(zk, shares[i])

    proofs = run_parties(party, 3)
    assert proofs[0] == proofs[1] == proofs[2]
    assert [len(x) for x in drawn] == [2, 2, 2]
    fr = engines[2].f
    blinding = [fr.add(fr.add(drawn[0][k], drawn[1][k]), drawn[2][k]) for k in range(2)]
    return proofs[0], engines, blinding


def _plain_proof(circuit, blinding, **where):
    """A Plain proof with r and s pinned; returns (proof, driver)."""
    zk, _, wit, _ = circuit
    d = port_driver.PlainDriver(PBN254, **where)
    values = iter(blinding)
    d.rand = lambda shape=(): next(values)
    return CoGroth16(d).prove(zk, split_witness_plain(wit, 2, device=CPU)), d


@pytest.fixture(scope="module")
def single_device_proof(small_engines, circuit, rep3_sharded):
    return _plain_proof(circuit, rep3_sharded[2], device=CPU)[0]


def test_rep3_proof_through_devices_equals_single_device_proof(circuit, rep3_sharded,
                                                               single_device_proof):
    _, vk, _, publics = circuit
    got, (g1_eng, g2_eng, ntt), _ = rep3_sharded
    assert isinstance(g1_eng, ShardedMSMEngine) and isinstance(g2_eng, ShardedMSMEngine)
    assert isinstance(ntt, ShardedNTTEngine)
    assert g1_eng.last_waves > 0 and g2_eng.last_waves > 0
    assert got == single_device_proof
    assert verify_groth16(vk, got, publics)
    assert not verify_groth16(vk, got, [publics[0] + 1, publics[1]])


def test_plain_proof_through_devices_equals_single_device_proof(small_engines, circuit,
                                                                rep3_sharded,
                                                                single_device_proof):
    _, vk, _, publics = circuit
    got, d = _plain_proof(circuit, rep3_sharded[2], devices=[CPU] * 2)
    assert isinstance(d.msm_g1_engine, ShardedMSMEngine)
    assert isinstance(d.msm_g2_engine, ShardedMSMEngine)
    assert isinstance(d.ntt, ShardedNTTEngine) and d.device == CPU
    assert d.msm_g1_engine.last_waves > 0 and d.msm_g2_engine.last_waves > 0
    assert got == single_device_proof
    assert verify_groth16(vk, got, publics)


def test_rep3_driver_passes_devices_through():
    def party(i, net):
        d = port_rep3.Rep3Driver(PBN254, net, devices=[CPU] * 3)
        return (type(d.msm_g1_engine), type(d.msm_g2_engine), type(d.ntt), d.devices, d.device)

    for got in run_parties(party, 3):
        assert got == (ShardedMSMEngine, ShardedMSMEngine, ShardedNTTEngine, (CPU,) * 3, CPU)


def test_rep3_driver_with_one_device_keeps_the_local_engines():
    from cocircom_tpu_torch.ops.msm import MSM
    from cocircom_tpu_torch.ops.ntt import NTTEngine

    def party(i, net):
        d = port_rep3.Rep3Driver(PBN254, net, devices=[CPU])
        return type(d.msm_g1_engine), type(d.ntt), d.devices

    for got in run_parties(party, 3):
        assert got == (MSM, NTTEngine, None)
