"""Host data layer: the benchmark's span around each ``next()`` on
``Trainer.batches`` (the prefetch thread's queue, fed by the loader
threads), mean per window step, host clock."""

UNIT = "ms"


def read(run):
    if run.loop != "train" or not run.data_wait_s:
        return None
    return 1e3 * sum(run.data_wait_s) / len(run.data_wait_s)
