"""cocircom_tpu_torch: the PyTorch/CUDA port of the collaborative-SNARK
framework, written for one NVIDIA H100.

A 3-party REP3 (or Plain) co-Groth16 proof over BN254 or BLS12-381, end to
end, on one device or sharded over a list of devices.  Plain tensor code is
PyTorch; the field multiply, the NTT stage and column kernels, the point add
(G1, and a G2 instantiation) and the two G1 wave updates of the MSM (mixed
add, masked complete add) are hand-written CUDA C++ (csrc/), built at first
use for 8 and for 12 limbs.  Entry points default to the card and raise
without one; pass ``device="cpu"`` to run the plain versions.

Layer map (same sub-package names as the JAX package):
  ops/field.py, ops/curve.py  limb arithmetic, G1/G2 point arithmetic
  ops/ntt.py, ops/msm.py      NTT, Pippenger MSM
  ops/kernels.py, csrc/       CUDA kernel loader, wrappers and sources
  parallel/sharded.py         MSM and NTT engines over a list of devices
  mpc/                        Plain, REP3 and Shamir drivers, in-process and
                              TCP/TLS networks, the wire codec
  io/                         snarkjs artifacts (r1cs, wtns, zkey), .shared files
  vm/                         the circom witness extension
  cli.py                      the command line (python -m cocircom_tpu_torch.cli)
  snark/                      co-Groth16 prover, setup, pairing verifier
  convert.py                  numpy <-> port tensors (tests, carried data)
  graft_entry.py              the prover-core step, one device and several
"""

__version__ = "0.1.0"
