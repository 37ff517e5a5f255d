"""Carry data between the JAX package's layout and the port's.

Numpy in, port tensors out (and the inverses the tests need).  The JAX
package holds a field element as 2L limbs of 16 bits in uint32, limb axis
first; the port holds the same integer as L limbs of 32 bits in int32, limb
axis first.  Both use the same Montgomery R, so conversion pairs limbs and
does no arithmetic.  This module imports neither package's engines: the
reference side arrives as numpy arrays (or objects with numpy leaves).
What comes out lies on `device`: the card unless the caller names another.
"""

from __future__ import annotations

import numpy as np
import torch

from .io.zkey import G1Array, G2Array, Groth16ZKey, SparseMatrices
from .mpc.rep3 import Rep3FieldShare
from .ops.curve import ProjPoint
from .ops.field import pack16_to_32, resolve_device, unpack32_to_16


def field_from_reference(limbs16, device=None) -> torch.Tensor:
    """(2L, *batch) uint32 16-bit limbs -> (L, *batch) int32 tensor."""
    a = torch.from_numpy(np.asarray(limbs16).astype(np.int64))
    return pack16_to_32(a).to(resolve_device(device))


def field_to_reference(limbs32: torch.Tensor) -> np.ndarray:
    """(L, *batch) int32 tensor -> (2L, *batch) uint32 16-bit limbs."""
    return unpack32_to_16(limbs32.detach().cpu()).numpy().astype(np.uint32)


def _coord_from(c, device):
    if isinstance(c, (tuple, list)):
        return tuple(field_from_reference(x, device) for x in c)
    return field_from_reference(c, device)


def points_from_reference(pt, device=None) -> ProjPoint:
    """A reference ProjPoint with numpy leaves (G1 arrays or G2 pairs) ->
    the port's ProjPoint."""
    device = resolve_device(device)
    return ProjPoint(*(_coord_from(c, device) for c in pt))


def rep3_share_from_reference(share, device=None) -> Rep3FieldShare:
    """A reference Rep3FieldShare (a, b) with numpy leaves -> the port's."""
    device = resolve_device(device)
    return Rep3FieldShare(field_from_reference(share[0], device),
                          field_from_reference(share[1], device))


def binary_share_from_reference(share, device=None, limbs: int | None = None):
    """A reference Rep3BinaryShare (a, b) of 16-bit limbs with numpy leaves
    -> the port's, 32-bit limbs, zero-extended to `limbs` limbs if given
    (9 for BLS12-381 Fr)."""
    from .mpc.rep3_binary import Rep3BinaryShare

    def one(x):
        t = field_from_reference(x, device)
        if limbs is not None and limbs > t.shape[0]:
            t = torch.cat([t, t.new_zeros((limbs - t.shape[0],) + tuple(t.shape[1:]))])
        return t

    return Rep3BinaryShare(one(share[0]), one(share[1]))


def binary_share_to_reference(share):
    """The port's Rep3BinaryShare -> (a, b) numpy arrays of 16-bit limbs."""
    return tuple(field_to_reference(c) for c in share)


def circuit_from_reference(c):
    """A reference CompiledCircuit -> the port's, with the curve mapped (the
    tape holds only tuples of python strings and ints)."""
    from .vm.compiler import CompiledCircuit

    return CompiledCircuit(
        curve=_curve(c.curve), n_signals=c.n_signals, n_outputs=c.n_outputs,
        input_slots={k: list(v) for k, v in c.input_slots.items()},
        output_slots={k: list(v) for k, v in c.output_slots.items()},
        public_names=list(c.public_names), levels=[list(lv) for lv in c.levels],
        n_temps=c.n_temps)


def _index(a, device):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def zkey_from_reference(zk, device=None) -> Groth16ZKey:
    """A reference Groth16ZKey with numpy leaves -> the port's, on `device`."""
    device = resolve_device(device)
    def g1(arr):
        return G1Array(field_from_reference(arr.x, device),
                       field_from_reference(arr.y, device))

    m = zk.matrices
    mats = SparseMatrices(
        num_constraints=m.num_constraints,
        num_instance=m.num_instance,
        a_rows=_index(m.a_rows, device),
        a_cols=_index(m.a_cols, device),
        a_coeffs=field_from_reference(m.a_coeffs, device),
        b_rows=_index(m.b_rows, device),
        b_cols=_index(m.b_cols, device),
        b_coeffs=field_from_reference(m.b_coeffs, device),
    )
    b2 = zk.b_g2_query
    return Groth16ZKey(
        curve=_curve(zk.curve),
        n_vars=zk.n_vars,
        n_public=zk.n_public,
        domain_size=zk.domain_size,
        pow=zk.pow,
        alpha_g1=zk.alpha_g1,
        beta_g1=zk.beta_g1,
        beta_g2=zk.beta_g2,
        gamma_g2=zk.gamma_g2,
        delta_g1=zk.delta_g1,
        delta_g2=zk.delta_g2,
        ic=g1(zk.ic),
        a_query=g1(zk.a_query),
        b_g1_query=g1(zk.b_g1_query),
        b_g2_query=G2Array(*(field_from_reference(c, device)
                             for c in (b2.x0, b2.x1, b2.y0, b2.y1))),
        l_query=g1(zk.l_query),
        h_query=g1(zk.h_query),
        matrices=mats,
    )


def _curve(ref_curve):
    """The port's CurveParams of the same name (the reference's object is of
    another class and is not carried over)."""
    from .fields.params import curve_by_name

    return curve_by_name(ref_curve.name)
