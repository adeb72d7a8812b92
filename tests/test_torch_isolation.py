"""The port stands alone: importing every module of it loads no JAX, flax,
optax, PyYAML, PIL or module of the JAX package, and its entry points
refuse to run without CUDA unless the caller asks for the CPU."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "yaml", "PIL",
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
    assert {f"{PKG}.ops.branch_conv", f"{PKG}.models.hrnet"} <= set(got["modules"])
    assert {f"{PKG}.ops.metrics", f"{PKG}.engine.evaluator", f"{PKG}.engine.compat",
            f"{PKG}.eval"} <= set(got["modules"])
    assert {f"{PKG}.engine.checkpoint", f"{PKG}.models.unet", f"{PKG}.methods.supervised",
            f"{PKG}.methods.mean_teacher", f"{PKG}.methods.cps"} <= set(got["modules"])
    assert got["bad"] == []


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on the card's machine, which has no JAX: its own
    imports and every port module it loads stay clear of JAX."""
    probe = ("import json, sys; sys.argv = ['chip_smoke.py']; import chip_smoke; "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
             "'optax', 'semi_supervised_semantic_segmentation_tpu')); print(json.dumps(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


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
    from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_eval.main(["--config", os.path.join(REPO, "configs",
                                                 "3_fixmatch_dlv3p_r50_voc_512.yaml"),
                        "--checkpoint", "x.pth"])
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
    out = capsys.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    # the reference's records: {"train": {...}}, step = i + epoch * iters_per_epoch,
    # then the one eval of train.epochs=1: {"val": {"step": 0, ...}}
    assert all(list(r) == ["train"] for r in records[:-1]) and list(records[-1]) == ["val"]
    val = records[-1]["val"]
    assert val["step"] == 0 and 0.0 <= val["miou"] <= 1.0 and "acc" in val
    assert last["best_miou"] == val["miou"] and out[-2] == f"best mIoU: {val['miou']:.4f}"
    lines = [r["train"] for r in records[:-1]]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(r["time"] >= 0 for r in lines)
    assert all(np.isfinite(r["loss"]) for r in lines)
    assert last["loss"] == lines[-1]["loss"]
    assert (tmp_path / "config.yaml").exists() and not (tmp_path / "config.json").exists()


def test_train_entry_point_builds_and_trains_config5_on_an_explicit_cpu(tmp_path, capsys):
    """Config 5 as shipped (HRNet + HRNetV2Head, remat 'stages:3',
    branch_conv 'pallas', OHEM) through ``python -m ...train --device cpu``,
    narrowed to width 8 and one module per stage at crop 64."""
    from semi_supervised_semantic_segmentation_tpu_torch import train

    train.main([
        "--config", os.path.join(REPO, "configs", "5_hrnet_w48_1024_full_ssl.yaml"),
        "--device", "cpu", "--work_dir", str(tmp_path),
        "--set", "data.dataset=synthetic", "data.crop_size=64", "data.synthetic_size=4",
        "data.num_workers=1", "model.hrnet_width=8", "model.hrnet_modules=[1,1,1]",
        "train.labeled_batch_size=2", "train.unlabeled_batch_size=2", "train.epochs=1",
        "train.iters_per_epoch=2", "train.log_interval=1",
    ])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(last["loss"]) and np.isfinite(last["sup_loss"])
    # config 5's eval protocol (sliding, flip, six scales: the staged path)
    assert 0.0 <= last["best_miou"] <= 1.0
