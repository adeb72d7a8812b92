"""Set-up time: from the process's start to the first timed step or val
batch (imports, the kernels' build or load, data and weights made from the
seed, the trainer or evaluator made, the checked steps and the warm-up)."""

UNIT = "s"


def read(run):
    return run.setup_s
