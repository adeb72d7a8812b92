"""The port's steps and eval on real-data layouts: a tiny Cityscapes tree
(64 x 128 images, trainIds labels, no split directory) read by both
packages' ``build_dataset`` and ``Loader`` into Cityscapes' non-square
1024 x 2048 canvas, then

- one supervised step and one CPS step (``cps_impl: separate``) on
  U-Net/ResNet-18 (crop 64, float32), the port's nets carried across from
  the reference's initialisation with ``engine/compat.py``, under random
  scale (0.5-2.0) - crop - flip: the reference's draws of each step replayed
  into the port's ``WeakParams``.  Tolerances are the existing step tests':
  supervised as tests/test_torch_supervised.py (lr 0.05; losses rtol = atol = 2e-3,
  each tensor's update within 15 % of the reference's by relative norm,
  running statistics rtol 1e-3 / atol 1e-3 max|v|, lr within 1e-6); CPS as
  tests/test_torch_cps.py (lr 0.01; losses 2e-3, ``cps_loss`` 1e-2, every tensor of
  both nets within 5e-3 as max|a-b| / max(max|a|, 0.1));
- the eval confusion matrix (sliding 64 / 24, flip, scales 0.75 and 1.0:
  the staged path, config 4's) of the val images on a non-square 80 x 160 canvas
  (the images plus blank padding; the 1024 x 2048 canvas would tile into
  thousands of windows on the CPU): equal to the reference's, probabilities
  within ``PROB_TOL`` = 1e-4 (tests/test_torch_evaluator.py).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.data import datasets as jdatasets
from semi_supervised_semantic_segmentation_tpu.data import pipeline as jpipeline
from semi_supervised_semantic_segmentation_tpu.methods import cps as jcps
from semi_supervised_semantic_segmentation_tpu.methods import supervised as jsupervised
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.data import datasets, pipeline
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat, evaluator
from semi_supervised_semantic_segmentation_tpu_torch.methods import cps, supervised
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment
from tests.test_torch_evaluator import PROB_TOL, assert_confusion_agrees, jax_eval, port_eval
from tests.torch_port_helpers import one_torch_thread, steps_against_jax

NCLS, CROP, NL, NU = 19, 64, 2, 2
HW = (64, 128)
TRAIN = [f"{city}/{city}_{i:06d}_000019" for city in ("aachen", "bremen") for i in range(4)]
VAL = ["frankfurt/frankfurt_000000_000294", "lindau/lindau_000000_000019"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _blob_sample(seed):
    """A smooth image whose classes are legible (so that a step's loss and
    the eval's argmax are not noise) and its trainIds label."""
    rng = np.random.RandomState(seed)
    h, w = HW
    yy, xx = np.mgrid[0:h, 0:w]
    label = np.zeros((h, w), np.uint8)
    img = np.full((h, w, 3), 60.0) + rng.rand(h, w, 3) * 30
    for c in rng.choice(np.arange(1, NCLS), 4, replace=False):
        cy, cx, ry, rx = rng.rand(4) * [h, w, h / 3, w / 3] + [0, 0, 6, 6]
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        label[m] = c
        img[m] = [(c * 67 + k * 41) % 255 for k in range(3)]
    label[:3] = 255
    return img.astype(np.uint8), label


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    for image_set, ids in (("train", TRAIN), ("val", VAL)):
        for i, sid in enumerate(ids):
            city = sid.split("/")[0]
            for top in ("leftImg8bit", "gtFine"):
                os.makedirs(os.path.join(root, top, image_set, city), exist_ok=True)
            img, lab = _blob_sample((0 if image_set == "train" else 100) + i)
            Image.fromarray(img).save(
                os.path.join(root, "leftImg8bit", image_set, sid + "_leftImg8bit.png"))
            Image.fromarray(lab, mode="L").save(
                os.path.join(root, "gtFine", image_set, sid + "_gtFine_labelTrainIds.png"))
    return root


def _raw(root, method, **data):
    return {
        "data": {"dataset": "cityscapes", "data_root": root, "split": "1_4",
                 "num_classes": NCLS, "crop_size": CROP, "scale_min": 0.5, "scale_max": 2.0,
                 "hflip_prob": 0.5, "num_workers": 2, **data},
        "model": {"backbone": "resnet18", "decoder": "unet", "output_stride": 32,
                  "compute_dtype": "float32"},
        "method": {"name": method, "cps_weight": 1.5},
        # the learning rates of tests/test_torch_supervised.py and test_torch_cps.py
        "optim": {"lr": 0.05 if method == "supervised" else 0.01, "weight_decay": 1e-4},
        "train": {"labeled_batch_size": NL, "unlabeled_batch_size": NU, "eval_batch_size": 2},
    }


def _first_batch(root, raw, role, batch):
    """The first batch of ``role``'s loader in each package (seed 0), held
    equal, as numpy."""
    got = []
    for cfg, dmod, pmod in ((jconfig.config_from_dict(raw), jdatasets, jpipeline),
                            (config.config_from_dict(raw), datasets, pipeline)):
        ds = dmod.build_dataset(cfg, role)
        assert ds.canvas_hw == (1024, 2048)
        got.append(next(pmod.Loader(ds, batch, seed=0, num_workers=2).epoch(0)))
    for k in got[0]:
        np.testing.assert_array_equal(got[1][k], got[0][k], err_msg=k)
    assert all((s == HW).all() for s in got[1]["size"])
    return {k: v for k, v in got[1].items() if k != "index"}


def _replay_weak(key, sizes, d) -> augment.WeakParams:
    """The reference's ``weak_augment_batch`` draws under ``key``
    (``ops/augment.py::_weak_single``) as the port's ``WeakParams``."""
    s, oy, ox, flip = [], [], [], []
    for k, (h, w) in zip(jax.random.split(key, len(sizes)), sizes):
        ks, koy, kox, kf = jax.random.split(k, 4)
        sc = jax.random.uniform(ks, (), minval=d["scale_min"], maxval=d["scale_max"])
        sh = jnp.maximum(jnp.round(h * sc), 1.0)
        sw = jnp.maximum(jnp.round(w * sc), 1.0)
        s.append(float(sc))
        oy.append(float(jnp.floor(jax.random.uniform(koy, ()) * (jnp.maximum(sh - CROP, 0.0) + 1))))
        ox.append(float(jnp.floor(jax.random.uniform(kox, ()) * (jnp.maximum(sw - CROP, 0.0) + 1))))
        flip.append(bool(jax.random.uniform(kf, ()) < d["hflip_prob"]))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return augment.WeakParams(scale=f32(s), oy=f32(oy), ox=f32(ox), flip=torch.tensor(flip))


def _step_key(jstate):
    return jax.random.fold_in(jax.random.wrap_key_data(jstate.rng), jstate.step)


def test_supervised_step_on_the_tree_matches_jax(tree):
    raw = _raw(tree, "supervised")
    lab = _first_batch(tree, raw, "labeled", NL)
    jcfg = jconfig.config_from_dict(raw)
    jmodel = jbuild(jcfg)
    # the reference's state of steps_against_jax, for its step-0 draws
    kaug, _ = jax.random.split(_step_key(jsupervised.init_state(jcfg, jmodel,
                                                                jax.random.key(0), 1)))
    weak = _replay_weak(kaug, lab["size"], raw["data"])
    assert weak.flip.any() and not weak.flip.all()  # both orientations in the batch
    jl, tl = steps_against_jax(jcfg, jmodel, jsupervised, config.config_from_dict(raw),
                               supervised, 1, [lab], None,
                               lambda i: supervised.Draws(weak_l=weak, dropout=None),
                               ("loss", "sup_loss"))
    assert np.isfinite(jl).all()
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)


def test_cps_step_on_the_tree_matches_jax(tree):
    raw = _raw(tree, "cps")
    lab = _first_batch(tree, raw, "labeled", NL)
    unlab = _first_batch(tree, raw, "unlabeled", NU)
    assert (unlab["label"] == 255).all()
    jcfg = jconfig.config_from_dict(raw)
    jmodel = jbuild(jcfg)
    jstate = jcps.init_state(jcfg, jmodel, jax.random.key(0), 1)
    kl, ku, _, _ = jax.random.split(_step_key(jstate), 4)
    draws = cps.Draws(weak_l=_replay_weak(kl, lab["size"], raw["data"]),
                      weak_u=_replay_weak(ku, unlab["size"], raw["data"]),
                      dropout1=None, dropout2=None)
    cfg = config.config_from_dict(raw)
    state = cps.init_state(cfg, build_model(cfg), 1)
    for net, name in ((state.model, "net1"), (state.model2, "net2")):
        compat.load_flax_variables(net, jax.device_get(jstate.params[name]),
                                   jax.device_get(jstate.batch_stats[name]))
    jstate, jm = jax.jit(jcps.make_train_step(jcfg, jmodel, 1))(
        jstate, *({k: jnp.asarray(v) for k, v in b.items()} for b in (lab, unlab)))
    tm = cps.make_train_step(cfg, 1)(
        state, *({k: torch.from_numpy(v) for k, v in b.items()} for b in (lab, unlab)), draws)
    assert float(jm["cps_loss"]) > 0
    np.testing.assert_allclose([float(tm[k]) for k in ("loss", "sup_loss")],
                               [float(jm[k]) for k in ("loss", "sup_loss")], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(tm["cps_loss"]), float(jm["cps_loss"]), rtol=1e-2, atol=1e-2)
    for net, name in ((state.model, "net1"), (state.model2, "net2")):
        got = net.state_dict()
        flat = compat.flatten_params_to_torch_layout(jax.device_get(jstate.params[name]),
                                                     jax.device_get(jstate.batch_stats[name]))
        for k, v in flat.items():
            rel = np.max(np.abs(v - got[k].numpy())) / max(np.max(np.abs(v)), 0.1)
            assert rel < 5e-3, (name, k, rel)


@pytest.fixture(scope="module")
def eval_pair(tree):
    raw = _raw(tree, "supervised")
    jcfg = jconfig.config_from_dict(raw)
    jmodel = jbuild(jcfg)
    jstate = jsupervised.init_state(jcfg, jmodel, jax.random.key(1), 1)
    model = build_model(config.config_from_dict(raw))
    compat.load_flax_variables(model, jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    val = datasets.build_dataset(config.config_from_dict(raw), "val")
    batch = next(pipeline.Loader(val, 2, shuffle=False, drop_last=False, pad_mode="blank",
                                 num_workers=2, canvas_hw=(80, 160)).epoch(0))
    return jmodel, jstate.params, jstate.batch_stats, model, batch


def test_eval_confusion_on_a_non_square_canvas_equals_jax(tree, eval_pair, monkeypatch):
    jmodel, params, stats, model, batch = eval_pair
    raw = _raw(tree, "supervised", eval_mode="sliding", eval_stride=24, eval_flip=True,
               eval_scales=[0.75, 1.0])
    assert evaluator.use_staged(config.config_from_dict(raw))
    batch = {k: batch[k] for k in ("image", "label")}
    cm_ref, prob_ref = jax_eval(raw, jmodel, params, stats, batch, monkeypatch)
    cm, prob = port_eval(raw, model, batch)
    assert cm.sum() == (batch["label"] != 255).sum() > 0
    assert assert_confusion_agrees(cm, cm_ref, prob, prob_ref, batch["label"], NCLS,
                                   tol=PROB_TOL) == 0
    np.testing.assert_array_equal(cm, cm_ref)
