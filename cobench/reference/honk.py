"""The plain reference of the co-UltraHonk cells: host Python integers and
frozen copies of the port's host UltraHonk code (`host/honk/`, `host/noir/`,
commit e513b03), nothing of the program.

The setup's points are [tau^i]G1 for a tau the reference derives from the
seed as the setup's builder does, so a commitment to a public polynomial is
f(tau) G1: the verifying key is the frozen builder's and proving key's 27
precomputed polynomials of the chain's circuit, each evaluated at tau, and
g2_x = tau G2.  A proof is right when its public inputs are the chain's
input lane 0 and its output, computed here from the proof's inputs as
drawn, and the frozen verifier accepts it: the sumcheck over all 26
subrelations, ZeroMorph and the KZG pairing, in full.
"""

from __future__ import annotations

from .host.fields.ec_host import ec_mul
from .host.fields.params import BN254
from .host.honk import verifier
from .host.honk.builder import UltraCircuitBuilder, acir_to_format
from .host.honk.crs import _g1_gen, _g2_gen
from .host.honk.proving_key import create_keys
from .host.noir import acir

P = BN254.fr.p


class KnownTau:
    """The setup as its builder knows it: commit(f) = f(tau) G1."""

    def __init__(self, tau: int):
        self.tau = tau % P
        self.g1 = _g1_gen()
        self.g2_x = ec_mul(_g2_gen(), self.tau)

    def commit(self, poly):
        acc = 0
        for c in reversed(poly):
            acc = (acc * self.tau + c) % P
        return ec_mul(self.g1, acc) if acc else None


def verifying_key(circuit_of, tau: int):
    """The verifying key of the circuit `circuit_of(acir)` builds from the
    frozen ACIR types, over the setup of tau."""
    af = acir_to_format(circuit_of(acir))
    builder = UltraCircuitBuilder(af, [0] * af.varnum)
    _pk, vk = create_keys(builder, KnownTau(tau))
    return vk


def public_inputs(proof: list) -> list:
    """The public inputs a proof carries (after its circuit size, their
    count and their offset)."""
    return list(proof[3:3 + proof[1]]) if len(proof) > 3 else []


def check_proof(proof: list, vk, expected: list) -> bool:
    """Whether the proof carries `expected` as its public inputs and the
    frozen verifier accepts it under vk."""
    if public_inputs(proof) != [x % P for x in expected]:
        return False
    try:
        return bool(verifier.verify(list(proof), vk))
    except (ValueError, IndexError, ZeroDivisionError):
        return False
