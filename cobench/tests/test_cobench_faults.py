"""Whole runs of the harness, its look for a card left out: each kind of
cell at a tiny size on the CPU, sound, with the control, and with a fault
planted in the timed path, and `correct` comes out as it must.  The faults
a proof cell can have: an answer altered where it is produced.  (A proof
has no state that a step could leave unchanged, no batch whose mean is
taken, and these cells no exchange between chips.)  The control at the
cells' own sizes needs the card (`chip`).

A Groth16 proof of 16 constraints takes two to three minutes here (the
kernels' plain versions), so these runs leave out the warm-up proof."""

import pytest

from cobench import manifest, parties, run
from cobench.tests.conftest import need_card

SEED = 2**31 + 4242
# each kind of cell: (configuration, traffic, the tiny size)
CELLS = {"groth16_rep3_2p20": ("groth16_bn254_2p20", "rep3_closed", {"log_constraints": 4}),
         "groth16_shamir_2p20": ("groth16_bn254_2p20", "shamir_closed", {"log_constraints": 4})}
SMALL = sorted(CELLS)


def cell(name: str) -> dict:
    config, traffic, _ = CELLS[name]
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def wrong(res: dict) -> int:
    return sum(c["value"] for c in res["checks"].values())


def small_run(name: str, **kw) -> dict:
    config = dict(manifest.load_config(CELLS[name][0]), **CELLS[name][2])
    return run.run_cell(manifest.load_benchmark(), cell(name), SEED, 0.0, False, "cpu",
                        config=config, warm_up=False, **kw)


@pytest.mark.parametrize("name", SMALL)
def test_a_sound_run_is_correct(name):
    res = small_run(name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 1 and wrong(res) == 0
    assert set(res["metrics"]) == {"setup_s", "proof_s", "peak_gib", "rounds_per_proof",
                                   "sent_mib_per_proof"}
    assert list(res)[-1] == "checks"


def test_every_proof_of_the_window_is_checked():
    # one sound proof of witness 0; as the window's second proof it stands
    # where witness 1's proof belongs, and the check has to see that
    config = dict(manifest.load_config(CELLS["groth16_rep3_2p20"][0]),
                  **CELLS["groth16_rep3_2p20"][2])
    prover = manifest.prover("groth16").Cell(config, manifest.load_traffic("rep3_closed"),
                                              SEED, "cpu")
    r0 = parties.prove(prover.party_fn(prover.job(0)), False, lambda: None)
    assert sum(r0.rounds) > 0
    assert prover.check([r0]) == [("proofs_wrong", 0, 0)]
    assert prover.check([r0, r0]) == [("proofs_wrong", 1, 0)]


@pytest.mark.parametrize("name", ["groth16_rep3_2p20"])
def test_the_control_is_not_correct(name):
    res = small_run(name, control=True)
    assert not res["correct"] and wrong(res) >= 1


def alter_groth16(monkeypatch):
    from cocircom_tpu_torch.snark.groth16 import CoGroth16

    from cobench.reference.groth16 import Curves, _ints1, ec_add

    orig = CoGroth16.prove

    def prove(self, zkey, shared):
        out = orig(self, zkey, shared)
        cv = Curves()
        return dict(out, pi_c=_ints1(ec_add(cv.pt1(out["pi_c"]), cv.g1)))

    monkeypatch.setattr(CoGroth16, "prove", prove)


@pytest.mark.parametrize("name,plant", [("groth16_rep3_2p20", alter_groth16)])
def test_an_answer_altered_where_it_is_produced_is_not_correct(name, plant, monkeypatch):
    plant(monkeypatch)
    res = small_run(name)
    assert not res["correct"] and wrong(res) >= 1


@pytest.mark.chip
@pytest.mark.parametrize("name", ["groth16_rep3_2p20", "groth16_shamir_2p20"])
def test_the_control_fails_at_the_cells_own_size(name):
    need_card()
    res = run.run_cell(manifest.load_benchmark(), cell(name), SEED, 0.0, False, "cuda",
                       control=True)
    assert not res["correct"] and wrong(res) >= 1
