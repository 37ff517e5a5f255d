"""The share of ec_madd's roofline over one profiled proof, in percent: the
least time of its launches' work (`cobench.roofline`, counted from each
launch's shapes and inputs) over the device time the profiler gives the
kernel.  Nothing where the kernel did not run."""

from cobench.roofline import share_pct


def read(run):
    if run.profile is None or run.bounds is None:
        return None
    return share_pct(run.bounds["ec_madd"], run.profile.kernel_seconds("ec_madd"))
