"""The window's arithmetic, the roofline counts and share, and the
reduction of a device trace, against values worked out by hand."""

import pytest

from cobench import roofline, trace, window
from cobench.parties import ProofRun


def runs():
    # three proofs: 10.0-12.5, 13.0-16.5, 17.0-18.5 s, the dealer's work in
    # the gaps; party 1 sends the most
    return [ProofRun([None] * 3, 10.0, 12.5, [7, 7, 6], [100, 300, 200], {"a": 1.0}),
            ProofRun([None] * 3, 13.0, 16.5, [7, 7, 6], [100, 300, 200], {"a": 2.0, "b": 0.5}),
            ProofRun([None] * 3, 17.0, 18.5, [7, 8, 6], [100, 300 + (1 << 20), 200], {})]


def test_proof_s_is_the_window_over_its_whole_proofs():
    # the proofs' own walls: the gaps between them are off the clock
    assert window.elapsed(runs()) == pytest.approx(7.5)
    assert window.proof_s(runs()) == pytest.approx(7.5 / 3)


def test_rounds_and_bytes_take_the_busiest_party_a_proof():
    assert window.rounds_per_proof(runs()) == pytest.approx(22 / 3)
    assert window.sent_mib_per_proof(runs()) == pytest.approx((900 + (1 << 20)) / 3 / (1 << 20))


def test_spans_are_summed_a_proof_and_absent_spans_read_nothing():
    assert window.span_per_proof(runs(), "a") == pytest.approx(1.0)
    assert window.span_per_proof(runs(), "a", "b") == pytest.approx(3.5 / 3)
    assert window.span_per_proof(runs(), "c") is None


def test_end_to_end_gathers_every_metric():
    e = window.end_to_end(runs(), 40.0, 3 << 30)
    assert e["setup_s"] == 40.0 and e["peak_gib"] == 3.0


def test_integer_peak_is_its_stated_derivation():
    assert roofline.INT_MAD_RATE == pytest.approx(132 * 64 * 1.98e9)


def test_mont_mul_work_and_bound():
    # 8 limbs: 32 B an element, 2 * 64 + 8 = 136 multiply-adds a product
    nbytes, mads = roofline.mont_mul_work(8, 1 << 20, False, True)
    assert nbytes == 32 * ((1 << 20) + 1 + (1 << 20)) and mads == 136 * (1 << 20)
    assert roofline.bound_s(nbytes, mads) == pytest.approx(
        max(nbytes / 3.35e12, mads / (132 * 64 * 1.98e9)))


def test_ntt_columns_work():
    # 1024-point columns, 1024 of them, with a (8, 1024, 1024) factor table
    prods = 10 * 512 - 1023
    nbytes, mads = roofline.ntt_columns_work(8, 1024, 1024, 1024, True)
    assert nbytes == 2 * 32 * (1 << 20) + 32 * 512 + 32 * (1 << 20)
    assert mads == prods * 1024 * 136 + (1 << 20) * 136


def test_ec_madd_work():
    msq = 36 + 64 + 8
    nbytes, mads = roofline.ec_madd_work(8, 22, 2049, 1000)
    assert nbytes == 16 * 22 * 2049 + (64 + 192) * 1000
    assert mads == (7 * 136 + 4 * msq) * 1000


def test_roofline_share_is_a_percentage_and_silent_without_device_time():
    assert roofline.share_pct(0.5, 2.0) == 25.0
    assert roofline.share_pct(0.5, 0.0) is None


def test_trace_summary_unions_intervals_and_names_gaps():
    ev = [(0, 100, "void k1<8>(int*)"), (50, 150, "k2"), (300, 400, "void k1<8>(int*)"),
          (1000, 1100, "k3")]
    p = trace.summarize(ev, 2e-6)
    assert p.busy_s == pytest.approx(350e-9) and p.ops == 4
    assert p.by_name["void k1<8>(int*)"] == pytest.approx(200e-9)
    assert p.gaps[0] == ("before k3", pytest.approx(600e-9))
    b = trace.breakdown(p)
    assert b["device_ops"][0] == ["k1", pytest.approx(200e-9)]
    assert b["idle_gaps"][1] == ["before k1", pytest.approx(150e-9)]
