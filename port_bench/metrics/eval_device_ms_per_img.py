"""Summed kernel time per val image over the profiled batches."""

UNIT = "ms"


def read(run):
    t = run.trace
    if run.loop != "eval" or t is None or not t.kernels() or not t.images:
        return None
    return 1e3 * t.device_s() / t.images
