"""Device kernels launched per training step, counted in the profiled
steps (memory copies and sets left out)."""

UNIT = "launches"


def read(run):
    t = run.trace
    if run.loop != "train" or t is None or not t.kernels():
        return None
    return len(t.kernels()) / t.units
