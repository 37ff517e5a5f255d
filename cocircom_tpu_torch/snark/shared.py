"""SharedWitness / SharedInput construction and merging: a witness file
split for the provers, an input file split for the witness extension.

Parity: co-circom/co-circom-snarks/src/lib.rs (SharedWitness :24,
SharedInput :45, merge :119, share_rep3 :151, share_shamir :177).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

from ..fields.params import CurveParams
from ..io.witness import Witness
from ..ops.field import get_field
from .groth16 import SharedWitness


class SharedInput(NamedTuple):
    """One party's input share for the collaborative witness extension.

    Public inputs are known in-clear to every party; private inputs arrive
    secret-shared, possibly from several independent input providers
    (merged with `merge_inputs`).

    public_inputs: {signal name: [int, ...]}
    shared_inputs: {signal name: driver share vec (batch = flat size)}
    """

    public_inputs: dict
    shared_inputs: dict


def merge_inputs(a: SharedInput, b: SharedInput) -> SharedInput:
    """Union two input shares from different providers with the upstream
    sanity checks (lib.rs:119-149): no duplicate shared signal, no signal
    both public and shared, public values equal everywhere."""
    shared = dict(a.shared_inputs)
    public = dict(a.public_inputs)
    for k, v in b.shared_inputs.items():
        if k in shared:
            raise ValueError(f"input {k!r} present in multiple input shares")
        if k in public or k in b.public_inputs:
            raise ValueError(f"input {k!r} is both shared and public")
        shared[k] = v
    for k, v in b.public_inputs.items():
        if k in shared:
            raise ValueError(f"input {k!r} is both shared and public")
        if k in public and [int(x) for x in public[k]] != [int(x) for x in v]:
            raise ValueError(f"public input {k!r} differs between files")
        public[k] = v
    return SharedInput(public, shared)


def split_input_rep3(curve: CurveParams, inputs: dict, public_names,
                     seed=None, device=None) -> list[SharedInput]:
    """Dealer-side: split an input.json dict into 3 REP3 SharedInputs, the
    shares on `device` (the card unless the caller names another).  Public
    signals (the circuit's `{public [...]}` list) are replicated in-clear;
    everything else is secret-shared.

    Parity: bin/co-circom.rs run_split_input (:255-335)."""
    from ..mpc.rep3 import share_field_vec
    from ..vm.mpc_vm import flatten_inputs

    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    out = [SharedInput({}, {}) for _ in range(3)]
    for name, val in inputs.items():
        flat = [v % curve.fr.p for v in flatten_inputs(val)]
        if name in public_names:
            for s in out:
                s.public_inputs[name] = flat
        else:
            # a distinct mask key per signal name from a test seed
            per_name = (None if seed is None else hashlib.sha256(
                str(seed).encode() + b"\x00" + name.encode()).digest())
            shares = share_field_vec(fr, fr.encode(flat), seed=per_name)
            for s, sh in zip(out, shares):
                s.shared_inputs[name] = sh
    return out


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
