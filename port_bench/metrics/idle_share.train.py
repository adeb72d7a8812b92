"""Share of the window's time in which the device ran nothing: one less
the device's busy time per step in the profiled part (the union of its
operations) over the wall time per step of the unprofiled window.  The
profiled part's own wall time is not the denominator: tracing costs the
host some microseconds a launch, which slows a host-paced step."""

UNIT = "%"


def read(run):
    t = run.trace
    if run.loop != "train" or t is None or not t.device or not run.attempted:
        return None
    per_unit = run.window_ms / 1e3 / run.attempted
    return 100.0 * (1.0 - t.busy_s() / t.units / per_unit)
