"""Party 0's `honk.commit` spans a proof, in seconds: each commitment's MSM
over the shares (one engine call a group of polynomials) and its opening;
its turns include the other parties'."""

from cobench.window import span_per_proof


def read(run):
    return span_per_proof(run.runs, "honk.commit")
