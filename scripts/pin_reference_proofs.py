"""Write tests/reference_proofs.json: the JAX package's proofs of the
inputs that the port tests pinned to it hand it (tests/reference_pins.py).

Run it from the repository's root after any change to cocircom_tpu/, to
tests/reference_pins.py or tests/torch_port_util.py, to jax or jaxlib, or
to a pinned test's inputs (tests/test_harness.py and the pinned tests fail
until then):

    python scripts/pin_reference_proofs.py

It imports tests/conftest.py first, so the JAX package runs as it does
in the tests (the CPU backend, eight host devices, serialized compiles).
"""

import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each module's reference_inputs(): the inputs its tests would hand the
# JAX package's provers
MODULES = (
    "test_torch_groth16", "test_torch_groth16_rep3", "test_torch_shamir",
    "test_torch_bls12_381_groth16", "test_torch_plonk", "test_torch_plonk_mpc",
    "test_torch_honk", "test_torch_co_honk",
)


def main():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import conftest  # noqa: F401  the tests' JAX settings
    import reference_pins as pins

    proofs = {}
    for name in MODULES:
        for inputs in importlib.import_module(name).reference_inputs():
            t0 = time.perf_counter()
            proofs[pins.pin_key(inputs)] = {"kind": inputs["kind"], "module": name,
                                            "proof": pins.prove(inputs)}
            print(f"{name}: {inputs['kind']} in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"made_by": pins.SCRIPT, **pins.freshness(), "proofs": proofs}
    pins.PINS.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"{len(proofs)} proofs -> {pins.PINS.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
