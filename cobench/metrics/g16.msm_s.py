"""Party 0's MSM spans a proof, in seconds: the h and l MSMs, and the A/B
coefficient MSMs with the opening endgame; its turns include the other
parties'."""

from cocircom_tpu_torch.snark.groth16 import SPAN_ENDGAME, SPAN_MSM_HL

from cobench.window import span_per_proof


def read(run):
    return span_per_proof(run.runs, SPAN_MSM_HL, SPAN_ENDGAME)
