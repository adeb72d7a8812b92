"""Run records (counterpart of the reference's ``utils/logging.py``): the
``train.log`` copy of the log and ``MetricLogger``'s JSON lines and
TensorBoard scalars."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

_FORMAT = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%H:%M:%S")


def log_to_file(log: logging.Logger, work_dir: str) -> logging.Handler:
    """Copy ``log``'s records to ``<work_dir>/train.log`` (the reference's
    ``setup_logging``); the caller removes and closes the handler it gets."""
    os.makedirs(work_dir, exist_ok=True)
    handler = logging.FileHandler(os.path.join(work_dir, "train.log"))
    handler.setFormatter(_FORMAT)
    log.addHandler(handler)
    return handler


class MetricLogger:
    """The reference's ``MetricLogger``: each record is one JSON line
    ``{prefix: {"step", "time", **scalars}}`` of ``<work_dir>/metrics.jsonl``
    (time in seconds since the logger was made) and, where ``tensorboardX``
    imports (optional, as in the reference), one TensorBoard scalar
    ``f"{prefix}/{name}"`` at ``step`` per scalar in ``<work_dir>/tb``.  With
    ``write`` false (every rank but world rank 0) it builds the records and
    writes nothing."""

    def __init__(self, work_dir: str, write: bool = True):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "metrics.jsonl")
        self.write = write
        self._tb = None
        if write:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(work_dir, "tb"))
        self._t0 = time.time()

    def log_scalars(self, step: int, scalars: Dict[str, float], prefix: str = "train") -> dict:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self.write:
            with open(self.path, "a") as f:
                f.write(json.dumps({prefix: rec}) + "\n")
            if self._tb is not None:
                for k, v in scalars.items():
                    self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
        return rec

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
