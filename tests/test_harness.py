"""The freshness of the pinned JAX reference proofs (tests/reference_pins.py)."""

import json

import reference_pins


def test_reference_pins_are_fresh():
    """The pins were made from this tree's JAX package, these recipes and
    this jax/jaxlib."""
    pins = json.loads(reference_pins.PINS.read_text())
    now = reference_pins.freshness()
    assert {k: pins.get(k) for k in now} == now, \
        f"the pinned JAX reference proofs are stale: run python {reference_pins.SCRIPT}"
