"""The port's run records against the reference's: the ``config.yaml`` a
run saves (written by either side, read by both) and the ``metrics.jsonl``
records (shape and step numbering of ``utils/logging.py::MetricLogger``):
the ``train`` records of the steps and, since ``fit`` evaluates, one
``val`` record per eval (step = epoch, ``miou``, ``acc``, ``iou/<name>``
for the finite IoUs, as the reference's ``Trainer.evaluate``)."""

import gc
import glob
import json
import math
import os
import weakref

import pytest
import yaml

from semi_supervised_semantic_segmentation_tpu import config as ref_config
from semi_supervised_semantic_segmentation_tpu.utils.logging import MetricLogger as RefLogger
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import MetricLogger, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_port_saved_config_loads_on_both_sides(path, tmp_path):
    cfg = config.load_config(path)
    out = str(tmp_path / "config.yaml")
    config.save_config(cfg, out)
    assert config.load_config(out).to_dict() == cfg.to_dict()
    assert ref_config.load_config(out).to_dict() == cfg.to_dict()
    assert config.load_config(out).name == ref_config.load_config(out).name == cfg.name


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reference_saved_config_loads_in_the_port(path, tmp_path):
    """The reference's ``yaml.safe_dump`` writes block lists (``- 0.485``
    at the key's indent): the port reads them."""
    ref = ref_config.load_config(path)
    out = str(tmp_path / "config.yaml")
    ref_config.save_config(ref, out)
    got = config.load_config(out)
    assert got.to_dict() == ref.to_dict() and got.name == ref.name


def test_parse_yaml_reads_the_scalars_safe_dump_writes():
    d = {"a": {"n": None, "t": True, "f": False, "e": 1e-05, "big": 1e20, "neg": -2.5e-7,
               "inf": math.inf, "s": "1_8", "q": "it's", "empty": "", "colon": "stages:3",
               "word": "yes", "num": "0.5"},
         "l": [0.485, 1, "x", None, True], "deep": {"inner": {"l": [1, 2]}}, "z": []}
    text = yaml.safe_dump(d, sort_keys=False)
    assert config.parse_yaml(text) == yaml.safe_load(text) == d
    # block lists indented deeper than their key, as other writers emit them
    assert config.parse_yaml("k:\n    - 1\n    - 2\nj: 3\n") == {"k": [1, 2], "j": 3}
    # and the port's own writer is read back the same by both
    mine = config.dump_yaml(d)
    assert config.parse_yaml(mine) == yaml.safe_load(mine) == d
    # a list item that reads as a string with ': ' in it stays a string
    assert config.parse_yaml("k:\n  - 'a: 1'\n") == yaml.safe_load("k:\n  - 'a: 1'\n")
    for bad in ("k:\n  - - 1\n", "- 1\n", "k:\n  - 1\n  j: 2\n", "k:\n  - a: 1\n"):
        with pytest.raises(ValueError):
            config.parse_yaml(bad)


def test_metric_record_matches_the_reference_logger(tmp_path):
    scalars = {"loss": 1.25, "sup_loss": 0.5, "lr": 0.01, "images_per_sec": 12.0}
    RefLogger(str(tmp_path / "ref"), enable_tb=False).log_scalars(7, scalars, "train")
    MetricLogger(str(tmp_path / "port")).log_scalars(7, scalars, "train")
    recs = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            recs.append(json.loads(f.read().strip()))
    ref, port = recs
    assert list(port) == list(ref) == ["train"]
    assert list(port["train"]) == list(ref["train"])
    assert port["train"]["time"] >= 0 and round(port["train"]["time"], 3) == port["train"]["time"]
    for r in (ref, port):
        r["train"].pop("time")
    assert port == ref


def test_val_record_matches_the_reference_logger(tmp_path):
    """The record ``Trainer.evaluate`` writes, through both loggers."""
    scalars = {"miou": 0.375, "acc": 0.8125, "iou/class_0": 0.5, "iou/class_2": 0.25}
    RefLogger(str(tmp_path / "ref"), enable_tb=False).log_scalars(3, scalars, "val")
    MetricLogger(str(tmp_path / "port")).log_scalars(3, scalars, "val")
    recs = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            recs.append(json.loads(f.read().strip()))
    ref, port = recs
    assert list(port) == list(ref) == ["val"]
    assert list(port["val"]) == list(ref["val"])
    for r in (ref, port):
        r["val"].pop("time")
    assert port == ref


def _check_val_records(recs, epochs):
    """One ``val`` record per eval, in the reference's shape."""
    val = [r["val"] for r in recs if list(r) == ["val"]]
    assert [r["step"] for r in val] == list(epochs)
    for r in val:
        assert list(r)[:4] == ["step", "time", "miou", "acc"]
        assert all(k.startswith("iou/") and math.isfinite(v) for k, v in list(r.items())[4:])
        assert 0.0 <= r["miou"] <= 1.0 and 0.0 <= r["acc"] <= 1.0 and r["time"] >= 0
    return val


def _tiny_config3(work_dir, **train):
    return config.load_config(os.path.join(REPO, "configs", "3_fixmatch_dlv3p_r50_voc_512.yaml"), {
        "data.dataset": "synthetic", "data.crop_size": 32, "data.synthetic_size": 4,
        "data.num_workers": 1, "model.compute_dtype": "float32", "train.labeled_batch_size": 2,
        "train.unlabeled_batch_size": 2, "train.work_dir": str(work_dir),
        **{f"train.{k}": v for k, v in train.items()}})


def test_trainer_numbers_steps_as_the_reference(tmp_path):
    """Two epochs of two steps, logged every second step: the reference's
    step = i + epoch * iters_per_epoch gives 1 and 3."""
    cfg = _tiny_config3(tmp_path, epochs=2, iters_per_epoch=2, log_interval=2)
    best = Trainer(cfg, device="cpu").fit()
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert all(list(r) in (["train"], ["val"]) for r in lines)
    recs = [r["train"] for r in lines if list(r) == ["train"]]
    assert [r["step"] for r in recs] == [1, 3]
    # an eval after each epoch (eval_interval 1), after that epoch's steps
    assert [list(r)[0] for r in lines] == ["train", "val", "train", "val"]
    val = _check_val_records(lines, range(2))
    assert best == max(r["miou"] for r in val)
    assert recs[0]["time"] <= recs[1]["time"]
    assert config.load_config(str(tmp_path / "config.yaml")).to_dict() == cfg.to_dict()


def test_trainer_is_released_after_fit(tmp_path):
    """``fit`` ends the prefetch thread, which would otherwise wait on its
    full queue and keep the trainer (model, optimizer state) alive."""
    trainer = Trainer(_tiny_config3(tmp_path, epochs=1, iters_per_epoch=1), device="cpu")
    trainer.fit()
    ref = weakref.ref(trainer)
    del trainer
    gc.collect()
    assert ref() is None
