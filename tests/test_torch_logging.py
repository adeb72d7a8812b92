"""The port's ``utils/logging.py::MetricLogger`` against the reference's
``utils/logging.py::MetricLogger``, with a stub ``tensorboardX`` in
``sys.modules`` that records the calls, whether or not the package is
installed: the same ``add_scalar`` calls (tag ``<prefix>/<name>``, value,
step) and the same JSON lines (less ``time``), ``close()`` closes the
writer, and a logger with ``write`` false (any rank but world rank 0)
writes nothing and opens no writer.  Without the package the JSON lines
alone are written.  Also the trainer's ``train.log`` copy through
``log_to_file``."""

from __future__ import annotations

import json
import logging
import os
import sys
import types

import pytest

from semi_supervised_semantic_segmentation_tpu.utils.logging import MetricLogger as RefLogger
from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import (
    MetricLogger as TrainerLogger,
)
from semi_supervised_semantic_segmentation_tpu_torch.utils.logging import (
    MetricLogger,
    log_to_file,
)

RECORDS = [(0, {"loss": 1.25, "sup_loss": 0.5, "lr": 0.01}, "train"),
           (1, {"loss": 1.0, "mask_ratio": 0.75, "images_per_sec": 12.0}, "train"),
           (0, {"miou": 0.5, "acc": 0.75, "iou/background": 0.25}, "val")]


class _Writer:
    """Records what a ``tensorboardX.SummaryWriter`` is asked to do."""

    made = []

    def __init__(self, logdir):
        self.logdir, self.calls, self.closed = logdir, [], False
        _Writer.made.append(self)

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))

    def close(self):
        self.closed = True


@pytest.fixture
def stub_tb(monkeypatch):
    _Writer.made = []
    monkeypatch.setitem(sys.modules, "tensorboardX",
                        types.SimpleNamespace(SummaryWriter=_Writer))
    return _Writer


def _lines(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        next(iter(r.values())).pop("time")
    return recs


def test_tensorboard_scalars_and_records_equal_the_reference(tmp_path, stub_tb):
    assert TrainerLogger is MetricLogger
    ref = RefLogger(str(tmp_path / "ref"))
    port = MetricLogger(str(tmp_path / "port"))
    for step, scalars, prefix in RECORDS:
        ref.log_scalars(step, scalars, prefix)
        port.log_scalars(step, scalars, prefix)
    w_ref, w_port = stub_tb.made
    assert w_ref.logdir == str(tmp_path / "ref" / "tb")
    assert w_port.logdir == str(tmp_path / "port" / "tb")
    assert w_port.calls == w_ref.calls and len(w_ref.calls) == 9
    assert w_port.calls[-1] == ("val/iou/background", 0.25, 0)
    assert _lines(tmp_path / "port" / "metrics.jsonl") == _lines(tmp_path / "ref" / "metrics.jsonl")
    ref.close()
    port.close()
    assert w_ref.closed and w_port.closed
    port.close()  # a second close is a no-op


def test_other_ranks_write_nothing(tmp_path, stub_tb):
    quiet = MetricLogger(str(tmp_path), write=False)
    rec = quiet.log_scalars(3, {"loss": 2.0})
    assert rec["step"] == 3 and rec["loss"] == 2.0
    quiet.close()
    assert stub_tb.made == [] and not os.path.exists(tmp_path / "metrics.jsonl")


def test_without_tensorboardx_the_records_are_written(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
    port = MetricLogger(str(tmp_path))
    port.log_scalars(0, {"loss": 1.0})
    port.close()
    assert _lines(tmp_path / "metrics.jsonl") == [{"train": {"step": 0, "loss": 1.0}}]
    assert not os.path.exists(tmp_path / "tb")


def test_log_to_file_copies_the_log(tmp_path):
    log = logging.getLogger("sstpu_torch.test_logging")
    log.setLevel(logging.INFO)
    handler = log_to_file(log, str(tmp_path / "run"))
    try:
        log.info("hello %d", 7)
    finally:
        log.removeHandler(handler)
        handler.close()
    with open(tmp_path / "run" / "train.log") as f:
        assert f.read().rstrip().endswith("] hello 7")
