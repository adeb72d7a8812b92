"""Port's config loader, YAML reader and host data against the JAX package:
equal config values for every checked-in config, the YAML reader against
``yaml.safe_load``, byte-equal synthetic samples and loader batches."""

import glob
import os

import numpy as np
import pytest
import yaml

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.data import datasets as jdatasets
from semi_supervised_semantic_segmentation_tpu.data import pipeline as jpipeline
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.data import datasets, pipeline

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "*.yaml")))


def test_five_configs_are_checked_in():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_fields_equal_jax(path):
    ours, theirs = config.load_config(path), jconfig.load_config(path)
    assert ours.name == theirs.name
    assert ours.to_dict() == theirs.to_dict()
    ov = {"optim.lr": 0.02, "data.eval_scales": [0.5, 1.0], "model.stem_impl": "pallas"}
    assert config.load_config(path, ov).to_dict() == jconfig.load_config(path, ov).to_dict()


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert config.parse_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_scalars_comments_and_refusals():
    text = (
        "# top comment\n"
        "a:\n"
        "  b: 1   # trailing\n"
        "  c: 'x # not a comment'\n"
        "  d: [0.5, 1, \"s\", true]\n"
        "  e:\n"
        "f: -2.5e-3\n"
        "g: null\n"
        "h: off\n"
    )
    assert config.parse_yaml(text) == yaml.safe_load(text)
    for bad in ("a:\n  - 1\n", "a: {b: 1}\n", "a: [[1]]\n", "a: 1\na: 2\n"):
        with pytest.raises(ValueError):
            config.parse_yaml(bad)


def test_set_overrides_parse_like_the_cli():
    got = config.parse_overrides(["data.split=1_16", "optim.lr=0.02", "train.epochs=3",
                                  "data.eval_flip=true", "data.eval_scales=[0.5,1.0]",
                                  "train.work_dir=/tmp/x"])
    assert got == {"data.split": "1_16", "optim.lr": 0.02, "train.epochs": 3,
                   "data.eval_flip": True, "data.eval_scales": [0.5, 1.0],
                   "train.work_dir": "/tmp/x"}
    with pytest.raises(ValueError, match="key=value"):
        config.parse_overrides(["lr"])


def test_aliases_validation_and_update_match_jax():
    flat = {"dataset": "voc", "backbone": "resnet50", "method": "fixmatch_cutmix", "lr": 0.004,
            "batch_size": 16, "ema_decay": 0.999, "confidence_threshold": 0.9}
    assert config.config_from_dict(flat).to_dict() == jconfig.config_from_dict(flat).to_dict()
    for bad in ({"bogus_key": 1}, {"data": {"bogus": 1}}, {"method": {"name": "nope"}},
                {"data": {"crop_size": 100}}, {"model": {"remat": "stages:3"}},
                {"model": {"branch_conv": "pallas"}}):
        with pytest.raises(ValueError):
            jconfig.config_from_dict(bad)
        with pytest.raises(ValueError):
            config.config_from_dict(bad)
    for impl in ("conv", "s2d", "pallas"):
        config.config_from_dict({"model": {"stem_impl": impl}, "data": {"cutmix_impl": "pallas"}})
    base = config.config_from_dict({})
    new = config.update_config(base, {"optim.lr": 0.5, "train.epochs": 3})
    assert new.optim.lr == 0.5 and new.train.epochs == 3 and base.optim.lr != 0.5


@pytest.mark.parametrize("gapped", [False, True])
def test_synthetic_samples_byte_equal(gapped):
    kw = dict(num_classes=5, size=4, image_hw=(48, 40), seed=3, labeled=True,
              appearance_range=(0.0, 1.0) if gapped else (0.0, 0.0))
    a, b = datasets.SyntheticDataset(**kw), jdatasets.SyntheticDataset(**kw)
    assert a.ids == b.ids
    for i in range(4):
        sa, sb = a.get(i), b.get(i)
        np.testing.assert_array_equal(sa.image, sb.image)
        np.testing.assert_array_equal(sa.label, sb.label)
        assert sa.size == sb.size


def test_split_and_dataset_roles_equal():
    ids = [f"img_{i:03d}" for i in range(50)]
    for split in ("1_16", "1_8", "1_4", "full"):
        assert datasets.deterministic_split(ids, split) == jdatasets.deterministic_split(ids, split)
    raw = {"data": {"dataset": "synthetic", "synthetic_size": 12, "split": "1_4",
                    "num_classes": 4}}
    ours, theirs = config.config_from_dict(raw), jconfig.config_from_dict(raw)
    for role in ("labeled", "unlabeled", "val"):
        a, b = datasets.build_dataset(ours, role), jdatasets.build_dataset(theirs, role)
        assert a.ids == b.ids and a.canvas_hw == b.canvas_hw and a.labeled == b.labeled
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        datasets.build_dataset(config.config_from_dict({"data": {"dataset": "voc"}}), "labeled")


def _loaders(mod_ds, mod_pipe):
    lab = mod_ds.SyntheticDataset(4, 6, image_hw=(32, 32), seed=0, labeled=True)
    unlab = mod_ds.SyntheticDataset(4, 10, image_hw=(32, 32), seed=2, labeled=False)
    return mod_pipe.DualLoader(mod_pipe.Loader(lab, 4, seed=1, num_workers=2),
                               mod_pipe.Loader(unlab, 3, seed=5, num_workers=2))


def test_loader_and_dual_loader_batches_byte_equal():
    ours, theirs = _loaders(datasets, pipeline), _loaders(jdatasets, jpipeline)
    assert len(ours) == len(theirs) == 3
    for epoch in range(2):
        pairs_a, pairs_b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(pairs_a) == len(pairs_b) == 3
        for (la, ua), (lb, ub) in zip(pairs_a, pairs_b):
            for x, y in ((la, lb), (ua, ub)):
                assert set(x) == set(y)
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
    ours.labeled.close()
    ours.unlabeled.close()
