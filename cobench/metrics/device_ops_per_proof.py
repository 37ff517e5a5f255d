"""Every device operation the profiler saw in one proof: the port's
kernels, PyTorch's glue, copies and sets."""


def read(run):
    return None if run.profile is None else run.profile.ops
