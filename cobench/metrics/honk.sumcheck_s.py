"""Party 0's `sumcheck` span a proof, in seconds: the co-sumcheck's rounds
(the 26 subrelations over the live edges, their products a depth one
round, the univariate opened, the partial evaluations); its turns include
the other parties'."""

from cobench.window import span_per_proof


def read(run):
    return span_per_proof(run.runs, "sumcheck")
