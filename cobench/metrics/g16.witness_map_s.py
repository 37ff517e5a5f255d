"""Party 0's witness-map span (constraints, then the iNTT / coset / NTT
transforms) a proof, in seconds; its turns include the other parties'."""

from cocircom_tpu_torch.snark.groth16 import SPAN_WITNESS_MAP

from cobench.window import span_per_proof


def read(run):
    return span_per_proof(run.runs, SPAN_WITNESS_MAP)
