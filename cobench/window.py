"""The arithmetic of the measured window, apart from anything that runs it.

The window is its proofs' own time, each from its start to its end: the
dealer's work between two proofs (drawing the next witness and splitting it
into shares, which no prover party does) is off the clock.  Proofs follow
one another until their time reaches the run's seconds; the proof that
crosses it finishes and counts, so the window holds whole proofs only.
Rounds, bytes and launches are counted inside each proof; rounds and bytes
are a party's own, and the metric takes the party that made the most over
the window.
"""

from __future__ import annotations

GIB = float(1 << 30)
MIB = float(1 << 20)


def elapsed(runs) -> float:
    """The window's seconds so far: its proofs' walls, summed."""
    return sum(r.end - r.start for r in runs)


def proof_s(runs) -> float:
    """The window's seconds over the number of proofs it completed."""
    return elapsed(runs) / len(runs)


def rounds_per_proof(runs) -> float:
    """The most rounds any party made over the window, a proof."""
    return max(sum(r.rounds[i] for r in runs) for i in range(len(runs[0].rounds))) / len(runs)


def sent_mib_per_proof(runs) -> float:
    """The most bytes any party sent over the window, in MiB a proof."""
    return max(sum(r.sent[i] for r in runs) for i in range(len(runs[0].sent))) / len(runs) / MIB


def span_per_proof(runs, *names) -> float | None:
    """Party 0's seconds in the named spans, summed, a proof; None where no
    proof of the window has any of them."""
    if not any(n in r.spans for r in runs for n in names):
        return None
    return sum(r.spans.get(n, 0.0) for r in runs for n in names) / len(runs)


def end_to_end(runs, setup_s: float, peak_bytes: int) -> dict:
    """{metric: value} of every end-to-end metric the harness knows."""
    return {"setup_s": setup_s, "proof_s": proof_s(runs), "peak_gib": peak_bytes / GIB,
            "rounds_per_proof": rounds_per_proof(runs),
            "sent_mib_per_proof": sent_mib_per_proof(runs)}
