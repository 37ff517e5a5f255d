"""The JAX package's proofs of the port tests' inputs, computed once and
pinned in tests/reference_proofs.json.

The JAX package is the reference the port is held to and is never edited,
so its proof of fixed inputs never changes; a cold JAX proof costs minutes
of XLA compiles in every test process.  A test that compares the port with
a pinned proof describes what it would hand the JAX package as an `inputs`
dict (its "kind" names the prover, every other entry is an argument, a seed
or a pinned draw) and looks the proof up by a sha256 over that dict.  The
provers below read nothing but `inputs`, so the key covers everything the
JAX package is given.  `scripts/pin_reference_proofs.py` runs them on each
pinned test module's `reference_inputs()` and writes the file, with a
sha256 over `cocircom_tpu/**/*.py`, one over each file of the recipes that
decide what the JAX package is handed (this file, tests/torch_port_util.py)
and the jax and jaxlib versions, which tests/test_harness.py compares with
the tree and the installation.

Stored proofs: Groth16 as its points, PLONK as the reference's JSON,
UltraHonk as a sha256 over the reference's proof buffer and its length.
"""

import functools
import hashlib
import json
import pathlib

import pytest
from torch_port_util import pin_rep3_seeds, run_named

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINS = ROOT / "tests" / "reference_proofs.json"
SCRIPT = "scripts/pin_reference_proofs.py"


def pin_key(inputs: dict) -> str:
    """sha256 over a canonical JSON form of `inputs` (bytes as hex)."""
    text = json.dumps(inputs, sort_keys=True, separators=(",", ":"),
                      default=lambda b: bytes(b).hex())
    return hashlib.sha256(text.encode()).hexdigest()


def source_digest() -> str:
    """sha256 over the JAX package's Python sources, path and bytes."""
    h = hashlib.sha256()
    pkg = ROOT / "cocircom_tpu"
    for path in sorted(pkg.rglob("*.py"), key=lambda p: p.relative_to(pkg).as_posix()):
        h.update(path.relative_to(pkg).as_posix().encode() + b"\0")
        h.update(hashlib.sha256(path.read_bytes()).digest())
    return h.hexdigest()


RECIPES = ("tests/reference_pins.py", "tests/torch_port_util.py")


def recipe_digests() -> dict:
    """sha256 of each file whose code builds what the provers below run."""
    return {name: hashlib.sha256((ROOT / name).read_bytes()).hexdigest() for name in RECIPES}


def freshness() -> dict:
    """What the pins were made from: the JAX package, the recipes, jax."""
    return {"cocircom_tpu_sha256": source_digest(), "recipe_sha256": recipe_digests(),
            **versions()}


def versions() -> dict:
    import jax
    import jaxlib

    return {"jax": jax.__version__, "jaxlib": jaxlib.__version__}


@functools.lru_cache(maxsize=None)
def _pins() -> dict:
    return json.loads(PINS.read_text())


def pinned(inputs: dict):
    """The pinned proof of `inputs`; fails the test when there is none."""
    key = pin_key(inputs)
    entry = _pins()["proofs"].get(key)
    if entry is None:
        pytest.fail(f"no pinned JAX reference proof of this {inputs['kind']} case "
                    f"(key {key[:16]}): run python {SCRIPT}")
    return entry["proof"]


def prove(inputs: dict):
    """The JAX package's proof of `inputs`, in the stored form."""
    import cocircom_tpu.ops.msm as msm

    with pytest.MonkeyPatch.context() as mp:
        try:
            out = _PROVERS[inputs["kind"]](inputs, mp)
        finally:
            msm.msm_engine.cache_clear()
    return json.loads(json.dumps(out))


def groth16_proof(entry: dict) -> dict:
    """A stored Groth16 proof as the provers return it (points as tuples)."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return {k: tup(entry[k]) for k in ("pi_a", "pi_b", "pi_c")}


def honk_digest(buffer: bytes) -> dict:
    """The stored form of an UltraHonk proof buffer (u32 count + 32-byte
    field elements)."""
    return {"sha256": hashlib.sha256(buffer).hexdigest(),
            "n": int.from_bytes(buffer[:4], "big")}


# ------------------------------------------------------------ the provers
# Each reads only `inputs` and runs only the JAX package.

def _curve(name):
    from cocircom_tpu.fields.params import BLS12_381, BN254

    return {c.name: c for c in (BN254, BLS12_381)}[name]


def _witness(curve, vals):
    from cocircom_tpu.io.witness import Witness
    from cocircom_tpu.ops.field import get_field

    return Witness(curve, len(vals), get_field(curve.fr.p, f"{curve.name}.fr").to_limbs(vals))


def _msm_t(mp, t):
    """The JAX package's MSM rank split, read from the environment when an
    engine is made (`prove` drops the engines made under it)."""
    import cocircom_tpu.ops.msm as msm

    mp.setenv("COCIRCOM_MSM_T", str(t))
    msm.msm_engine.cache_clear()


def _groth16_points(proofs):
    assert all(p == proofs[0] for p in proofs)
    return {k: proofs[0][k] for k in ("pi_a", "pi_b", "pi_c")}


def _groth16_plain(inp, mp):
    import cocircom_tpu.mpc.driver as driver
    from cocircom_tpu.io.zkey import read_groth16_zkey
    from cocircom_tpu.snark.groth16 import CoGroth16
    from cocircom_tpu.snark.shared import split_witness_plain

    curve = _curve(inp["curve"])
    _msm_t(mp, inp["msm_t"])
    rand = iter(inp["rand"])
    mp.setattr(driver.PlainDriver, "rand",
               lambda self, shape=(): self.fr.encode([next(rand)])[:, 0])
    zk = read_groth16_zkey(inp["zkey"])
    shared = split_witness_plain(_witness(curve, inp["witness"]), inp["n_public"])
    return _groth16_points([CoGroth16(driver.PlainDriver(curve)).prove(zk, shared)])


def _groth16_rep3(inp, mp):
    import cocircom_tpu.mpc.rep3 as rep3
    from cocircom_tpu.io.zkey import read_groth16_zkey
    from cocircom_tpu.mpc.runner import run_parties
    from cocircom_tpu.snark.groth16 import CoGroth16
    from cocircom_tpu.snark.shared import split_witness_rep3

    curve = _curve(inp["curve"])
    _msm_t(mp, inp["msm_t"])
    pin_rep3_seeds(mp, rep3, seeds=inp["prf_seeds"])
    zk = read_groth16_zkey(inp["zkey"])
    shares = split_witness_rep3(_witness(curve, inp["witness"]), inp["n_public"],
                                seed=inp["split_seed"])
    return _groth16_points(run_named(run_parties, lambda i, net: CoGroth16(
        rep3.Rep3Driver(curve, net)).prove(zk, shares[i])))


def _groth16_shamir(inp, mp):
    import cocircom_tpu.mpc.rep3 as rep3
    import cocircom_tpu.utils.chacha as chacha
    from cocircom_tpu.io.zkey import read_groth16_zkey
    from cocircom_tpu.mpc.runner import run_parties
    from cocircom_tpu.mpc.shamir import ShamirDriver
    from cocircom_tpu.snark.groth16 import CoGroth16
    from cocircom_tpu.snark.shared import split_witness_shamir

    curve = _curve(inp["curve"])
    _msm_t(mp, inp["msm_t"])
    pin_rep3_seeds(mp, chacha, rep3, seeds=inp["prf_seeds"])
    zk = read_groth16_zkey(inp["zkey"])
    t, n = inp["threshold"], inp["n_parties"]
    shares = split_witness_shamir(_witness(curve, inp["witness"]), inp["n_public"], t, n,
                                  seed=inp["split_seed"])
    return _groth16_points(run_named(run_parties, lambda i, net: CoGroth16(
        ShamirDriver(curve, net, t)).prove(zk, shares[i]), n))


def _plonk_plain(inp, mp):
    from cocircom_tpu.io.jsonio import dump_plonk_proof
    from cocircom_tpu.io.plonk_zkey import read_plonk_zkey
    from cocircom_tpu.mpc.driver import PlainDriver
    from cocircom_tpu.snark.plonk import CoPlonk
    from cocircom_tpu.snark.shared import SharedWitness

    curve = _curve(inp["curve"])
    _msm_t(mp, inp["msm_t"])
    mp.setenv("COCIRCOM_INSECURE_DETERMINISTIC", "1")
    d = PlainDriver(curve)
    shared = SharedWitness(inp["public"], d.fr.encode(inp["private"]))
    proof = CoPlonk(d, deterministic_blinding=inp["deterministic_blinding"]).prove(
        read_plonk_zkey(inp["zkey"]), shared)
    return dump_plonk_proof(curve, proof)


def _honk_circuit(program):
    from cocircom_tpu.honk.builder import acir_to_format
    from cocircom_tpu.noir.acir import load_program_json

    (c,), _ = load_program_json(program)
    return acir_to_format(c)


def _honk_plain(inp, mp):
    """The plain UltraHonk prover on TestCrs."""
    from cocircom_tpu.honk import prover
    from cocircom_tpu.honk.builder import UltraCircuitBuilder
    from cocircom_tpu.honk.crs import TestCrs
    from cocircom_tpu.honk.proving_key import create_keys

    pk, _vk = create_keys(UltraCircuitBuilder(_honk_circuit(inp["program"]), inp["witness"]),
                          TestCrs())
    return honk_digest(prover.proof_to_buffer(prover.prove(pk)))


def _honk_provider(inp, mp):
    """The plain UltraHonk prover over the provider-mode circuit (the
    oblivious ROM/RAM structure a co-prover proves): the builder runs with
    the plain driver, is finalized, and every shared value (the witness,
    the registered extras, the sorted RAM rows' access types, which the
    co-prover adds into w_4 at their rows) is filled in on the host before
    the keys are made."""
    import jax.numpy as jnp

    from cocircom_tpu.fields.params import BN254
    from cocircom_tpu.honk import prover
    from cocircom_tpu.honk.builder import P, UltraCircuitBuilder
    from cocircom_tpu.honk.co_builder import MpcBuilderValues
    from cocircom_tpu.honk.crs import TestCrs
    from cocircom_tpu.honk.proving_key import create_keys
    from cocircom_tpu.mpc.driver import plain_driver
    from cocircom_tpu.ops.field import get_field

    w = inp["witness"]
    rf = get_field(BN254.fr.p, "bn254.fr")
    dp = plain_driver(BN254)
    m = MpcBuilderValues(dp, dp.promote_public(rf.to_mont(jnp.asarray(rf.to_limbs(w)))))
    af = _honk_circuit(inp["program"])
    b = UltraCircuitBuilder(af, [0] * af.varnum, mpc=m)
    b.add_gates_to_ensure_all_polys_are_non_zero()
    b.finalize_circuit()

    def dec(h):
        return int(rf.from_limbs(rf.from_mont(h))[0])

    for i in range(af.varnum):
        b.variables[i] = w[i] % P
    for i, h in m.extra.items():
        b.variables[i] = dec(h)
    pk, _vk = create_keys(b, TestCrs())
    for r, h in zip(pk.memory_mixed_records, m.mixed_access):
        pk.witness[3][r] = (pk.witness[3][r] + dec(h)) % P
    pk.memory_read_records = list(pk.memory_read_records) + list(pk.memory_mixed_records)
    return honk_digest(prover.proof_to_buffer(prover.prove(pk)))


_PROVERS = {
    "groth16/plain": _groth16_plain,
    "groth16/rep3": _groth16_rep3,
    "groth16/shamir": _groth16_shamir,
    "plonk/plain": _plonk_plain,
    "honk/plain": _honk_plain,
    "honk/provider": _honk_provider,
}
