"""Eval throughput: val images through the whole protocol in the window's
whole batches over the time from its start to the last batch's
completion on the compute stream."""

from port_bench import stats

UNIT = "img/s"


def read(run):
    if run.loop != "eval" or not run.attempted:
        return None
    return stats.rate(run.window_images, run.window_ms)
