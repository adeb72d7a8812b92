"""Summed kernel time per profiled training step."""

UNIT = "ms"


def read(run):
    t = run.trace
    if run.loop != "train" or t is None or not t.kernels():
        return None
    return 1e3 * t.device_s() / t.units
