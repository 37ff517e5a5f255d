"""The port's own kernel launches over the window (`ops.kernels`'
counts, every kernel and limb count), a proof.  PyTorch's glue is not in
it: `device_ops_per_proof` counts that."""


def read(run):
    if not run.runs:
        return None
    return sum(run.launches.values()) / len(run.runs)
