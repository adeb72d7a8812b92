"""Training throughput: labeled and unlabeled images stepped in the window
over its length, from its start to the last step's completion on the
compute stream (no host synchronisation inside the window)."""

from port_bench import stats

UNIT = "img/s"


def read(run):
    if run.loop != "train" or not run.attempted:
        return None
    return stats.rate(run.window_images, run.window_ms)
