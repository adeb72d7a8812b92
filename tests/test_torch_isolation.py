"""The port stands alone: importing every module of it loads no JAX, flax,
optax, PyYAML or module of the JAX package, and its entry points refuse to
run without CUDA unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import semi_supervised_semantic_segmentation_tpu_torch as port
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "semi_supervised_semantic_segmentation_tpu_torch"

_PROBE = f"""
import importlib, json, pkgutil, sys
import {PKG} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "{PKG}.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "yaml",
                                    "semi_supervised_semantic_segmentation_tpu"))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def test_importing_every_module_loads_no_jax_or_reference_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert f"{PKG}.methods.fixmatch" in got["modules"]
    assert f"{PKG}.ops.stem" in got["modules"]
    assert got["bad"] == []


def _cfg(tmp_path):
    return config.config_from_dict({
        "data": {"dataset": "synthetic", "crop_size": 32, "synthetic_size": 4,
                 "num_workers": 1},
        "model": {"backbone": "resnet50", "decoder": "deeplabv3plus"},
        "method": {"name": "fixmatch_cutmix"},
        "train": {"labeled_batch_size": 2, "unlabeled_batch_size": 2,
                  "work_dir": str(tmp_path)},
    })


def test_trainer_without_a_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.resolve_device("cuda:0")
    assert port.resolve_device("cpu") == torch.device("cpu")


def test_train_entry_point_runs_on_an_explicit_cpu(tmp_path, capsys):
    """``python -m ...train --device cpu``: the trainer's loop, prefetcher
    and JSON metrics lines, at a toy size."""
    from semi_supervised_semantic_segmentation_tpu_torch import train

    train.main([
        "--config", os.path.join(REPO, "configs", "3_fixmatch_dlv3p_r50_voc_512.yaml"),
        "--device", "cpu", "--work_dir", str(tmp_path),
        "--set", "data.dataset=synthetic", "data.crop_size=32", "data.synthetic_size=4",
        "data.num_workers=1", "data.cutmix_impl=pallas", "model.compute_dtype=float32",
        "train.labeled_batch_size=2", "train.unlabeled_batch_size=2", "train.epochs=1",
        "train.iters_per_epoch=2", "train.log_interval=1",
    ])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in lines)
    assert last["loss"] == lines[-1]["loss"]
