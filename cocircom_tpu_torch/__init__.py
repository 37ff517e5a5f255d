"""cocircom_tpu_torch: the PyTorch/CUDA port of the collaborative-SNARK
framework, written for one NVIDIA H100.

First slice: a 3-party REP3 co-Groth16 proof over BN254, end to end.
Plain tensor code is PyTorch; the field multiply, the NTT stage and column
kernels, the point add (G1, and a G2 instantiation) and the G1 mixed-add
kernel are hand-written CUDA C++ (csrc/), built at first use.  Entry points default to the card and raise
without one; pass ``device="cpu"`` to run the plain versions.

Layer map (same sub-package names as the JAX package):
  ops/field.py, ops/curve.py  limb arithmetic, G1/G2 point arithmetic
  ops/ntt.py, ops/msm.py      NTT, Pippenger MSM
  ops/kernels.py, csrc/       CUDA kernel loader, wrappers and sources
  mpc/                        Plain and REP3 drivers, in-process network
  io/                         snarkjs artifacts (r1cs, wtns, zkey)
  snark/                      co-Groth16 prover, setup, pairing verifier
  convert.py                  numpy <-> port tensors (tests, carried data)
"""

__version__ = "0.1.0"
