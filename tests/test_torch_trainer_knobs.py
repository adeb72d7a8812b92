"""The trainer's ``train.*`` knobs that the port once parsed and never read
(``engine/trainer.py``), on the CPU with supervised U-Net/ResNet-18 at crop
32:

- ``profile_steps`` writes a ``torch.profiler`` trace under
  ``<work_dir>/profile``, with the program's spans (a FixMatch run);
- ``debug_nans`` raises on an injected NaN (and without it the same run
  ends with a NaN loss);
- ``resume`` with no checkpoint logs it and trains from step 0;
- ``python -m ...train --resume auto --device cpu`` resumes a run;
- every ``train.*`` field the config parses is read somewhere in the port.
"""

import dataclasses
import glob
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from semi_supervised_semantic_segmentation_tpu_torch import config, train
from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer
from semi_supervised_semantic_segmentation_tpu_torch.utils import spans
from tests.torch_port_helpers import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(REPO, "configs", "1_supervised_unet_r18_128.yaml")
SMALL = ["data.crop_size=32", "data.synthetic_canvas=32", "data.synthetic_size=32",
         "data.num_workers=1", "model.compute_dtype=float32", "train.labeled_batch_size=2",
         "train.eval_batch_size=8", "train.log_interval=1", "train.async_checkpoint=false"]


@pytest.fixture(autouse=True)
def _one_torch_thread(tmp_path):
    with one_torch_thread():
        yield
    # the slots (115-172 MB each) would stay in the kept base temp dirs
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(tmp_path, **over):
    return config.load_config(CONFIG1, {**config.parse_overrides(SMALL),
                                        "train.work_dir": str(tmp_path), **over})


def test_profile_steps_writes_a_trace(tmp_path):
    trainer = Trainer(_cfg(tmp_path, **{"train.epochs": 1, "train.iters_per_epoch": 4,
                                        "train.profile_steps": 1,
                                        "method.name": "fixmatch_cutmix",
                                        "train.unlabeled_batch_size": 2}), device="cpu")
    trainer.fit()
    names = os.listdir(tmp_path / "profile")
    assert names == ["trace_epoch0_steps2-3.json"]
    with open(tmp_path / "profile" / names[0]) as f:
        trace = json.load(f)
    ops = [e.get("name") for e in trace["traceEvents"]]
    assert "aten::convolution" in ops or "aten::conv2d" in ops
    # the program's spans record while the trainer profiles, and only then
    assert ops.count("fixmatch.step") == 2 and "fixmatch.backward" in ops
    assert "data.wait" in ops
    assert not spans._recording


def _nan_run(tmp_path, debug_nans):
    trainer = Trainer(_cfg(tmp_path, **{"train.epochs": 1, "train.iters_per_epoch": 2,
                                        "train.debug_nans": debug_nans}), device="cpu")
    with torch.no_grad():
        trainer.state.model.encoder.stem.Conv_0.weight[0, 0, 0, 0] = float("nan")
    return trainer


def test_debug_nans_raises_on_an_injected_nan(tmp_path):
    trainer = _nan_run(tmp_path / "on", True)
    with pytest.raises((RuntimeError, FloatingPointError), match="nan|non-finite"):
        trainer.fit()
    assert not torch.is_anomaly_enabled()
    trainer = _nan_run(tmp_path / "off", False)
    trainer.fit()
    assert math.isnan(trainer.last["loss"])


def test_resume_without_a_checkpoint_logs_and_trains_from_step_0(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger="sstpu_torch")
    trainer = Trainer(_cfg(tmp_path, **{"train.epochs": 1, "train.iters_per_epoch": 2,
                                        "train.resume": "auto"}), device="cpu")
    assert "resume requested but no checkpoint found in" in caplog.text
    assert trainer.start_epoch == 0 and trainer.state.step == 0
    trainer.fit()
    assert trainer.state.step == 2


def test_train_entry_point_resumes(tmp_path, capsys):
    args = ["--config", CONFIG1, "--device", "cpu", "--work_dir", str(tmp_path),
            "--set", *SMALL, "train.iters_per_epoch=2"]
    train.main(args + ["train.epochs=1"])
    capsys.readouterr()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # as the fixture above, for the child's torch
    out = subprocess.run(
        [sys.executable, "-m", "semi_supervised_semantic_segmentation_tpu_torch.train",
         *args, "train.epochs=2", "--resume", "auto"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resumed from" in out.stderr and "start_epoch=1" in out.stderr
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r["train"]["step"] for r in records if "train" in r]
    vals = [r["val"]["step"] for r in records if "val" in r]
    assert steps == [0, 1, 2, 3] and vals == [0, 1]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2", "4"]


def test_every_train_knob_is_read():
    pkg = os.path.join(REPO, "semi_supervised_semantic_segmentation_tpu_torch")
    src = ""
    for path in glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True):
        if not path.endswith("config.py"):
            with open(path) as f:
                src += f.read()
    unread = [f.name for f in dataclasses.fields(config.TrainConfig)
              if not re.search(rf"\.{f.name}\b", src)]
    assert unread == []
