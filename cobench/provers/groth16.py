"""co-Groth16 cells: the synthetic zkey of `frozen.synthetic_zkey`, built on
the device from the run's seed in set-up, and a fresh random witness a
proof, split into the traffic's shares (REP3, or Shamir with its
threshold) by the program's dealer functions.  Each proof is
`CoGroth16(driver).prove(zkey, share)` by three party threads.

The check (after the window) counts the window's wrong proofs: those whose
three parties' proofs differ or that fail the reference's pairing equation
(`reference/groth16.py`), every proof of the window held to both.  The control hands
the program each witness with its top 32-bit limb dropped (224-bit
arithmetic in place of the full 254 bits) and the reference the witness as
drawn."""

from __future__ import annotations

from ..frozen import synthetic_zkey
from ..seeds import derive

WITNESS_TOP_BITS = 29   # the top limb's bits: witness values below 2^253 < p


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        import torch

        from cocircom_tpu_torch.fields.params import curve_by_name
        from cocircom_tpu_torch.ops.field import get_field

        self.torch = torch
        self.curve = curve_by_name(config["curve"])
        self.log_n = int(config["log_constraints"])
        self.device = torch.device(device)
        self.protocol = traffic["protocol"]
        self.threshold = int(traffic.get("threshold") or 1)
        self.seed = seed
        self.control = control
        self.fr = get_field(self.curve.fr.p, self.curve.name + ".fr", self.device)
        self.zkey, self.mult = synthetic_zkey(self.curve, self.log_n, self.device,
                                              derive(seed, "zkey"))

    # ------------------------------------------------------------ inputs

    def witness(self, k):
        """Proof k's public input x and raw witness: (L, n_vars - 2) int32
        limbs of values below 2^253, drawn on the device from the seed."""
        torch = self.torch
        n = self.zkey.n_vars - 2
        gen = torch.Generator(device=self.device).manual_seed(derive(self.seed, "witness", k))
        raw = torch.randint(0, 1 << 32, (self.fr.L, n), generator=gen, dtype=torch.int64,
                            device=self.device)
        raw[-1] &= (1 << WITNESS_TOP_BITS) - 1
        x = derive(self.seed, "public", k) % self.curve.fr.p
        return x, raw.to(torch.int32)

    def job(self, k):
        """The three parties' shares of proof k's witness."""
        from cocircom_tpu_torch.mpc.rep3 import share_field_vec
        from cocircom_tpu_torch.mpc.shamir import share_field_vec_shamir
        from cocircom_tpu_torch.snark.groth16 import SharedWitness

        x, raw = self.witness(k)
        if self.control:
            raw[-1] = 0
        wit = self.fr.to_mont(raw)
        share_seed = derive(self.seed, "shares", k)
        if self.protocol == "rep3":
            shares = share_field_vec(self.fr, wit, seed=share_seed)
        else:
            shares = share_field_vec_shamir(self.fr, wit, self.threshold, 3, seed=share_seed,
                                            device=self.device)
        return [SharedWitness([1, x], s) for s in shares]

    def party_fn(self, job):
        from cocircom_tpu_torch.mpc.rep3 import Rep3Driver
        from cocircom_tpu_torch.mpc.shamir import ShamirDriver
        from cocircom_tpu_torch.snark.groth16 import CoGroth16

        def fn(i, net, tracer):
            if self.protocol == "rep3":
                d = Rep3Driver(self.curve, net, device=self.device)
            else:
                d = ShamirDriver(self.curve, net, self.threshold, device=self.device)
            return CoGroth16(d, tracer).prove(self.zkey, job[i])

        return fn

    # ------------------------------------------------------------- check

    def check(self, runs) -> list:
        """[(name, value, limit)]: the window's proofs that are wrong, a proof
        being wrong where its parties' proofs differ or where it fails the
        reference's equation for its witness as drawn."""
        from ..reference import groth16 as ref

        wrong = {i for i, r in enumerate(runs) if not r.proofs[0] == r.proofs[1] == r.proofs[2]}
        wm = ref.DeviceWitnessMap(self.log_n, self.device)
        items = []
        for k, r in enumerate(runs):
            x, raw = self.witness(k)
            z = self.torch.cat([wm.f.limbs([1, x]), wm.f.from_u32(raw)], dim=1)
            h = wm(z, self.zkey.n_public, self.zkey.matrices.num_constraints)
            items.append((r.proofs[0], wm.scalars(z, h, self.mult)))
            del z, h
        ok = ref.check_proofs(items)
        wrong |= {k for k, good in enumerate(ok) if not good}
        return [("proofs_wrong", len(wrong), 0)]
