"""The co-UltraHonk cell (`provers/honk.py`, `reference/honk.py`,
`honk_chain.py`): the chain's witness satisfies its circuit and its output
is the reference's; a sound proof is right and the control's proof is
wrong, by the reference, on the CPU at a tiny size (each proof a few
minutes here: the MSMs' plain versions) and, marked `chip`, at the cell's
own size."""

import pytest

from cobench import honk_chain, manifest, parties, run
from cobench.tests.conftest import need_card

SEED = 2**31 + 4243
CELL = {"name": "honk_rep3_2p16", "config": "honk_bn254_2p16", "traffic": "rep3_closed",
        "chips": 1}
TINY = {"log_rows": 6, "chain_rounds": 2}


def test_the_chain_witness_is_the_circuits_and_its_output_the_references():
    from cocircom_tpu_torch.fields.params import BN254
    from cocircom_tpu_torch.noir import acir

    p = BN254.fr.p
    rc = honk_chain.round_constants(p, SEED, 3)
    st = honk_chain.state(p, SEED, 0)
    c = honk_chain.circuit(acir, p, rc)
    w = honk_chain.witness(p, rc, st)
    assert len(w) == c.current_witness_index + 1 == 4 + 3 * honk_chain.GATES_PER_ROUND
    assert w[c.return_values[0]] == honk_chain.output(p, rc, st)
    for op in c.opcodes:      # every assert_zero holds
        e = op.expr
        total = e.q_c + sum(q * w[a] * w[b] for q, a, b in e.mul_terms)
        total += sum(q * w[a] for q, a in e.linear)
        assert total % p == 0
    assert honk_chain.state(p, SEED, 1) != st and honk_chain.round_constants(p, SEED + 1, 3) != rc


@pytest.fixture
def small_msm(monkeypatch):
    """A rank split of 2 in the MSM engines: the toy MSMs' bucket lanes are
    most of their time on the CPU."""
    from cocircom_tpu_torch.ops import msm

    monkeypatch.setattr(msm.MSM, "T_DEFAULT", 2)
    msm.msm_engine.cache_clear()
    yield
    msm.msm_engine.cache_clear()


def test_a_sound_proof_is_right_and_the_controls_is_wrong(small_msm):
    config = dict(manifest.load_config("honk_bn254_2p16"), **TINY)
    traffic = manifest.load_traffic("rep3_closed")
    for control, wrong in ((False, 0), (True, 1)):
        cell = manifest.prover("honk").Cell(config, traffic, SEED, "cpu", control)
        r = parties.prove(cell.party_fn(cell.job(0)), True, lambda: None)
        assert r.proofs[0] == r.proofs[1] == r.proofs[2]
        assert cell.check([r]) == [("proofs_wrong", wrong, 0)]
        if not control:
            assert r.spans["honk.commit"] > 0 and r.spans["sumcheck"] > 0
            # the window's proof k is held to job k's inputs
            assert cell.check([r, r]) == [("proofs_wrong", 1, 0)]


@pytest.mark.chip
def test_the_cells_own_size_sound_and_control():
    need_card()
    bench = manifest.load_benchmark()
    sound = run.run_cell(bench, CELL, SEED, 0.0, False, "cuda")
    assert sound["correct"] and sound["checks"]["proofs_wrong"]["value"] == 0
    control = run.run_cell(bench, CELL, SEED, 0.0, False, "cuda", control=True)
    assert not control["correct"] and control["checks"]["proofs_wrong"]["value"] >= 1
