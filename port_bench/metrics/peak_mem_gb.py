"""Peak device memory the program allocated over the warm-up and the
window (``torch.cuda.max_memory_allocated``), in 1e9 bytes."""

UNIT = "GB"


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
