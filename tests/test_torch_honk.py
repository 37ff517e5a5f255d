"""Port vs JAX package: the host-only UltraHonk copies (honk/builder.py,
proving_key.py, relations.py, sumcheck.py, zeromorph.py, prover.py,
verifier.py, transcript.py, noir/poseidon2.py, noir/acir.py).

The circuits are built in code (tests/torch_port_util.py: a chain of
squarings, a Poseidon-style permutation chain, a ROM/RAM circuit), written
as an ACIR program JSON and read back by both packages.  Everything is
compared exactly (tolerance 0): the ACIR format, the builder's blocks and
variables, the proving-key polynomials, the Poseidon2 permutation and the
transcript's challenges, the plain proof's field elements and its buffer
bytes; the port's verifier accepts the proof and refuses a tampered one or
a changed public input, as the JAX verifier does.  The JAX proofs are
made live here and must equal their pinned entries
(tests/reference_pins.py): this file is the UltraHonk anchor of the pins.
"""

import dataclasses
import random

import pytest
import reference_pins

from cocircom_tpu.honk import prover as ref_prover
from cocircom_tpu.honk import verifier as ref_verifier
from cocircom_tpu.honk.builder import UltraCircuitBuilder as RefBuilder
from cocircom_tpu.honk.builder import acir_to_format as ref_acir_to_format
from cocircom_tpu.honk.crs import TestCrs as RefCrs
from cocircom_tpu.honk.proving_key import create_keys as ref_create_keys
from cocircom_tpu.honk.transcript import Transcript as RefTranscript
from cocircom_tpu.noir import poseidon2 as ref_poseidon2
from cocircom_tpu.noir.acir import load_program_json as ref_load
from cocircom_tpu_torch.honk import prover, verifier
from cocircom_tpu_torch.honk.builder import P, UltraCircuitBuilder, acir_to_format
from cocircom_tpu_torch.honk.crs import TestCrs
from cocircom_tpu_torch.honk.proving_key import create_keys
from cocircom_tpu_torch.honk.transcript import Transcript
from cocircom_tpu_torch.noir import poseidon2
from cocircom_tpu_torch.noir.acir import load_program_json
from torch_port_util import acir_program_json, memory_circuit, poseidon_chain, squaring_chain

FIXTURES = {
    "chain": lambda: squaring_chain(16, 11),
    "poseidon": lambda: poseidon_chain(3, 12),
    "memory": lambda: memory_circuit(13),
}


def _reference_inputs(name):
    """What the JAX package's plain prover is handed for a fixture."""
    c, abi, w, _inputs = FIXTURES[name]()
    return {"kind": "honk/plain", "program": acir_program_json(c, abi), "witness": w}


def reference_inputs():
    return [_reference_inputs(name) for name in FIXTURES]


def _both(name):
    """(port circuit, JAX circuit, witness) of a fixture, each package
    reading the same program JSON."""
    c, abi, w, _inputs = FIXTURES[name]()
    js = acir_program_json(c, abi)
    (pc,), _ = load_program_json(js)
    (rc,), _ = ref_load(js)
    assert pc == c
    return pc, rc, w


def _fields(obj):
    """A dataclass tree as plain Python values (the two packages' classes
    differ, their fields must not)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    if isinstance(obj, set):
        return sorted(obj)
    return obj


@pytest.fixture(scope="module")
def keys():
    """Per fixture: port and JAX (builder, pk, vk) on the same witness."""
    out = {}
    for name in FIXTURES:
        pc, rc, w = _both(name)
        pb = UltraCircuitBuilder(acir_to_format(pc), w)
        rb = RefBuilder(ref_acir_to_format(rc), w)
        out[name] = (pb, *create_keys(pb, TestCrs()), rb, *ref_create_keys(rb, RefCrs()))
    return out


@pytest.mark.parametrize("name", list(FIXTURES))
def test_plain_proof_equals_reference_and_verifies(name, keys):
    """The port's plain prover gives the JAX package's proof, element for
    element and in buffer bytes; the port's verifier accepts it, refuses a
    changed commitment and a changed public input."""
    _pb, pk, vk, _rb, rpk, rvk = keys[name]
    proof = prover.prove(pk)
    want = ref_prover.prove(rpk)
    assert reference_pins.honk_digest(ref_prover.proof_to_buffer(want)) == \
        reference_pins.pinned(_reference_inputs(name))
    assert proof == want
    assert prover.proof_to_buffer(proof) == ref_prover.proof_to_buffer(want)
    assert prover.proof_from_buffer(prover.proof_to_buffer(proof)) == proof
    assert verifier.verify(proof, vk)
    bad = list(proof)
    bad[3 + pk.num_public_inputs] = (bad[3 + pk.num_public_inputs] + 1) % P
    assert not verifier.verify(bad, vk)
    changed = list(proof)
    changed[3] = (changed[3] + 1) % P
    assert not verifier.verify(changed, vk)


def test_reference_verifier_accepts_port_proof(keys):
    """The JAX verifier takes the port's chain proof and vk commitments."""
    _pb, pk, vk, _rb, _rpk, rvk = keys["chain"]
    assert [None if c is None else (c[0].v, c[1].v) for c in vk.commitments] == \
        [None if c is None else (c[0].v, c[1].v) for c in rvk.commitments]
    assert ref_verifier.verify(prover.prove(pk), rvk)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_vk_evaluated_by_a_driver_equals_reference(name, keys):
    """TestCrs with a plain driver (each polynomial evaluated at tau by
    evaluate_poly_public, as create-vk does on the card) gives the JAX
    package's vk commitments."""
    from cocircom_tpu_torch.fields.params import BN254
    from cocircom_tpu_torch.mpc.driver import PlainDriver

    pb, _pk, _vk, _rb, _rpk, rvk = keys[name]
    _pk2, vk = create_keys(pb, TestCrs(driver=PlainDriver(BN254, device="cpu")))
    assert [None if c is None else (c[0].v, c[1].v) for c in vk.commitments] == \
        [None if c is None else (c[0].v, c[1].v) for c in rvk.commitments]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_acir_format_builder_and_keys_equal_reference(name, keys):
    """acir_to_format, the builder's blocks, variables and copy structure,
    and every proving-key polynomial equal the JAX package's."""
    pc, rc, _w = _both(name)
    assert _fields(acir_to_format(pc)) == _fields(ref_acir_to_format(rc))
    pb, pk, _vk, rb, rpk, _rvk = keys[name]
    for blk in pb.blocks:
        assert pb.blocks[blk].wires == rb.blocks[blk].wires
        assert pb.blocks[blk].selectors == rb.blocks[blk].selectors
    assert pb.variables == rb.variables
    assert pb.real_variable_index == rb.real_variable_index
    assert pb.real_variable_tags == rb.real_variable_tags
    assert pk.circuit_size == rpk.circuit_size
    assert pk.precomputed == rpk.precomputed
    assert pk.witness == rpk.witness
    assert pk.public_inputs == rpk.public_inputs
    assert (pk.memory_read_records, pk.memory_write_records) == \
        (rpk.memory_read_records, rpk.memory_write_records)


def test_poseidon2_and_transcript_equal_reference():
    """The Poseidon2 permutation and hash on random states, and a
    transcript's challenges after field elements, points and u64s."""
    rng = random.Random(7)
    for _ in range(4):
        st = [rng.randrange(P) for _ in range(4)]
        assert poseidon2.permutation(list(st)) == ref_poseidon2.permutation(list(st))
        assert poseidon2.hash_fixed(st[:3], 2) == ref_poseidon2.hash_fixed(st[:3], 2)
    got, want = [], []
    for t, out in ((Transcript(), got), (RefTranscript(), want)):
        t.send_u64("n", 64)
        t.send_fr("x", 12345)
        t.send_point("W", (1, 2))
        t.send_fr_vec("v", [3, 4, 5])
        out.append(t.get_challenges(["a", "b"]))
        out.append(t.get_challenge("c"))
        out.append(list(t.proof_data))
    assert got == want
