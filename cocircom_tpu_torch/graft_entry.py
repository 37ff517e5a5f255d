"""Entry points of the flagship compute path, one device and several.

entry(device)               -- (fn, example_args): the co-Groth16 prover core
                               on one device, h = a*b - c then the G1 MSM of
                               h by `MSM._msm_fused`.
dryrun_multichip(n, device) -- the FULL sharded prover step over n devices:
                               three REP3 parties, each driving
                               `CoGroth16.prove` with a driver built with
                               `devices=`, so every prover MSM and (i)NTT
                               goes through parallel/sharded.py; then the
                               distributed four-step NTT alone at a size that
                               spans the devices.

Both run on the card unless the caller names a device.  The circuit is the
package's hand-built multiplier chain through `groth16_setup` and the zkey
loader, so nothing outside the repository is read.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields.params import BN254
from .ops.field import get_field, resolve_device


def _example_inputs(n: int, device):
    from .ops.curve import g1_ops

    curve = BN254
    fr = get_field(curve.fr.p, curve.name + ".fr", device)
    ops = g1_ops(curve, device)
    rng = np.random.default_rng(0)

    def vec():
        raw = rng.integers(0, 1 << 16, size=(fr.L, n), dtype=np.uint32) & 0x0FFF
        return fr.to_mont(fr.from_numpy(raw))

    a, b, c = vec(), vec(), vec()
    # points: small multiples of the generator (cheap to build, generic coords)
    gen = ops.encode_points([curve.g1_gen] * n)
    small = rng.integers(1, 1 << 15, size=(1, n), dtype=np.uint32)
    pts = ops.scalar_mul(gen, fr.from_numpy(small), nbits=16)
    return fr, ops, a, b, c, pts


def entry(device=None):
    """(fn, example_args): the one-device prover-core step."""
    from .ops.curve import ProjPoint
    from .ops.msm import msm_engine

    device = resolve_device(device)
    fr, ops, a, b, c, pts = _example_inputs(16, device)
    eng = msm_engine(ops)

    def fn(a, b, c, px, py, pz):
        h = fr.sub(fr.mont_mul(a, b), c)
        scal = fr.from_mont(h)
        res = eng._msm_fused(ProjPoint(px, py, pz), scal, 32 * fr.L, 4)
        return res.x, res.y, res.z

    return fn, (a, b, c, pts.x, pts.y, pts.z)


def dryrun_multichip(n_devices: int, device=None, n_mul: int = 12) -> None:
    """Three REP3 parties prove the multiplier chain of n_mul constraints,
    each through a driver that shards over n_devices devices (the visible
    cards in turn, or `device` n_devices times); the three proofs must be
    equal and the verifier must accept.  Then one sharded NTT at a size
    that spans the devices, held against the local engine."""
    from .io.r1cs import multiplier_chain
    from .io.witness import Witness
    from .io.zkey import read_groth16_zkey
    from .mpc.rep3 import Rep3Driver
    from .mpc.runner import run_parties
    from .ops.field import ints_to_limbs_np
    from .ops.ntt import ntt_engine
    from .parallel.sharded import device_list, sharded_ntt
    from .snark.groth16 import CoGroth16
    from .snark.groth16_verify import verify_groth16
    from .snark.setup import groth16_setup
    from .snark.shared import split_witness_rep3

    curve = BN254
    devices = device_list(n_devices, device)
    home = devices[0]
    fr = get_field(curve.fr.p, curve.name + ".fr", home)

    r1cs, vals = multiplier_chain(curve, n_mul, 3)
    zkey_bytes, vk = groth16_setup(r1cs, seed=b"graft")
    zk = read_groth16_zkey(zkey_bytes, device=home)
    wit = Witness(curve, len(vals), ints_to_limbs_np(vals, fr.L))
    shares = split_witness_rep3(wit, zk.n_public, seed=7, device=home)

    def party(i, net):
        d = Rep3Driver(curve, net, devices=devices)
        return CoGroth16(d).prove(zk, shares[i])

    proofs = run_parties(party, 3)
    if not proofs[0] == proofs[1] == proofs[2]:
        raise RuntimeError("sharded REP3 proofs differ")
    if not verify_groth16(vk, proofs[0], [vals[1], vals[2]]):
        raise RuntimeError("the verifier refused the sharded REP3 proof")

    # distributed NTT at a power-of-two size covering the devices
    logn = max(2 * (n_devices - 1).bit_length(), 6)
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 1 << 16, size=(fr.L, 1 << logn), dtype=np.uint32) & 0x0FFF
    coeffs = fr.to_mont(fr.from_numpy(raw))
    if not torch.equal(sharded_ntt(fr, curve.fr, devices)(coeffs),
                       ntt_engine(fr, curve.fr).ntt(coeffs)):
        raise RuntimeError("sharded NTT differs from the local engine")
