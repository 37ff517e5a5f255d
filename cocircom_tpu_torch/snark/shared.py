"""SharedWitness construction: a witness file split for the provers.

Parity: co-circom/co-circom-snarks/src/lib.rs (SharedWitness, share_rep3,
share_shamir).
"""

from __future__ import annotations

from ..io.witness import Witness
from ..ops.field import get_field
from .groth16 import SharedWitness


def witness_layout(w: Witness, n_public: int):
    """(public ints incl leading 1, aux standard limbs (L, N_aux) numpy)."""
    num_inputs = n_public + 1
    vals = w.values_ints()
    publics = vals[:num_inputs]
    aux_std = w.values_std[:, num_inputs:]
    return publics, aux_std


def split_witness_plain(w: Witness, n_public: int, device=None) -> SharedWitness:
    fr = get_field(w.curve.fr.p, w.curve.name + ".fr", device)
    publics, aux_std = witness_layout(w, n_public)
    return SharedWitness(publics, fr.to_mont(fr.from_numpy(aux_std)))


def split_witness_rep3(w: Witness, n_public: int, seed: int | None = None,
                       device=None):
    """Dealer-side split into 3 SharedWitness (one per party)."""
    from ..mpc.rep3 import share_field_vec

    fr = get_field(w.curve.fr.p, w.curve.name + ".fr", device)
    publics, aux_std = witness_layout(w, n_public)
    aux_mont = fr.to_mont(fr.from_numpy(aux_std))
    shares = share_field_vec(fr, aux_mont, seed=seed)
    return [SharedWitness(publics, s) for s in shares]


def split_witness_shamir(w: Witness, n_public: int, threshold: int, n_parties: int,
                         seed: int | None = None, device=None):
    """Dealer-side split into n_parties SharedWitness of degree-t Shamir
    shares, on `device` (the card unless the caller names another)."""
    from ..mpc.shamir import share_field_vec_shamir

    fr = get_field(w.curve.fr.p, w.curve.name + ".fr", device)
    publics, aux_std = witness_layout(w, n_public)
    aux_mont = fr.to_mont(fr.from_numpy(aux_std))
    shares = share_field_vec_shamir(fr, aux_mont, threshold, n_parties, seed=seed,
                                    device=fr.device)
    return [SharedWitness(publics, s) for s in shares]
