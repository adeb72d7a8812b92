"""95th percentile of every step time in the window: the interval between
consecutive step ends on the compute stream, the first from the window's
start."""

from port_bench import stats

UNIT = "ms"


def read(run):
    if run.loop != "train" or not run.attempted:
        return None
    return stats.percentile(stats.intervals(0.0, run.unit_ends_ms), 95)
