"""co-UltraHonk cells: the chain circuit of `honk_chain` (its round
constants from the run's seed), a setup of 2^log_rows points [tau^i]G1
made on the device in set-up by the program's `PointCrs.from_tau` (tau from
the seed; the program keeps no tau), and a fresh witness a proof: the
dealer evaluates the chain on the proof's input state and splits the
witness into REP3 shares before the proof's clock starts.  Each proof is
three party threads, each building the circuit (ACIR to builder, in
provider mode, and the keys inside the prover) as a co-noir party does and
proving with `CoUltraHonk(driver, setup).prove`.

The check (after the window) counts the window's wrong proofs: those whose
three parties' proofs differ, or whose public inputs are not the chain's
input lane 0 and output for the inputs as drawn, or that the frozen
verifier refuses under the reference's verifying key (`reference/honk.py`).
The control hands the program each witness with private lane 1 of the
input state changed, and the reference the inputs as drawn."""

from __future__ import annotations

from .. import honk_chain
from ..seeds import derive


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        import torch

        from cocircom_tpu_torch.fields.params import curve_by_name
        from cocircom_tpu_torch.honk.crs import PointCrs
        from cocircom_tpu_torch.noir import acir
        from cocircom_tpu_torch.ops.field import get_field

        if traffic["protocol"] != "rep3":
            raise ValueError("the co-UltraHonk cells run REP3 traffic")
        self.torch = torch
        self.curve = curve_by_name(config["curve"])
        self.p = self.curve.fr.p
        self.n = 1 << int(config["log_rows"])
        self.device = torch.device(device)
        self.seed = seed
        self.control = control
        self.fr = get_field(self.p, self.curve.name + ".fr", self.device)
        self.rc = honk_chain.round_constants(self.p, seed, int(config["chain_rounds"]))
        self.circuit = honk_chain.circuit(acir, self.p, self.rc)
        self.crs = PointCrs.from_tau(self.tau(), self.n, self.device)
        self._vk = None

    def tau(self) -> int:
        """The setup's secret, which only the setup's builder and the
        reference know."""
        return honk_chain.field_element(self.p, self.seed, "tau")

    # ------------------------------------------------------------ inputs

    def inputs(self, k) -> list:
        return honk_chain.state(self.p, self.seed, k)

    def job(self, k):
        """The three parties' REP3 shares of proof k's witness."""
        from cocircom_tpu_torch.mpc.rep3 import share_field_vec

        st = self.inputs(k)
        if self.control:
            st[1] = (st[1] + 1) % self.p
        w = self.fr.encode(honk_chain.witness(self.p, self.rc, st))
        return share_field_vec(self.fr, w, seed=derive(self.seed, "shares", k))

    def party_fn(self, job):
        from cocircom_tpu_torch.honk.builder import UltraCircuitBuilder, acir_to_format
        from cocircom_tpu_torch.honk.co_builder import MpcBuilderValues
        from cocircom_tpu_torch.honk.co_prover import CoUltraHonk
        from cocircom_tpu_torch.mpc.rep3 import Rep3Driver

        def fn(i, net, tracer):
            d = Rep3Driver(self.curve, net, device=self.device)
            af = acir_to_format(self.circuit)
            builder = UltraCircuitBuilder(af, [0] * af.varnum, mpc=MpcBuilderValues(d, job[i]))
            return CoUltraHonk(d, self.crs, tracer).prove(builder, job[i])

        return fn

    # ------------------------------------------------------------- check

    def check(self, runs) -> list:
        """[(name, value, limit)]: the window's proofs that are wrong."""
        from ..reference import honk as ref

        if self._vk is None:
            self._vk = ref.verifying_key(
                lambda acir: honk_chain.circuit(acir, self.p, self.rc), self.tau())
        wrong = {i for i, r in enumerate(runs) if not r.proofs[0] == r.proofs[1] == r.proofs[2]}
        for k, r in enumerate(runs):
            st = self.inputs(k)
            expected = [st[0], honk_chain.output(self.p, self.rc, st)]
            if not ref.check_proof(r.proofs[0], self._vk, expected):
                wrong.add(k)
        return [("proofs_wrong", len(wrong), 0)]
