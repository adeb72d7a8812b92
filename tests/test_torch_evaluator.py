"""The port's evaluator (``engine/evaluator.py``) against the JAX package's,
in float32 from the same weights (``load_flax_variables``) and the same
uint8 canvases made from a seed:

- ``_window_starts``, ``_snap`` and ``use_staged`` on a grid of sizes and
  settings;
- a width-8 HRNet + HRNetV2 head, the port with ``branch_conv: pallas``
  (its plain versions of the branch kernels), through whole, whole at
  ``eval_size``, sliding on a non-square canvas, flip, multi-scale, staged
  with and without ``eval_window_batch`` (the port's staged path against
  its fused one is in tests/test_torch_evaluator_staged.py).  The
  reference runs its Pallas kernels (interpret mode) in config 5's protocol
  case; elsewhere its XLA branch path, which tests/test_pallas_conv.py
  holds equal to them (an interpret-mode HRNet forward takes the CPU ~15 s
  to compile);
- ResNet-50 + DeepLabV3+ with ``stem_impl: pallas`` through config 3's
  whole + flip protocol.

The reference's summed probabilities are read where it takes their argmax.
Probabilities agree within ``PROB_TOL`` (f32 conv order through the model,
summed over up to 2 views x 3 scales); the confusion matrices are equal,
or differ only in pixels whose top-2 probability margin is under
``PROB_TOL`` (:func:`assert_confusion_agrees`).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.engine import evaluator as jevaluator
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu.ops import metrics as jmetrics
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import evaluator
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.test_torch_hrnet import JSeg

PROB_TOL = 1e-4  # the cases read max |dprob| 7.8e-6 to 2.2e-5
NCLS = 5


def _raw(**data):
    return {"data": {"dataset": "synthetic", "num_classes": NCLS, **data},
            "model": {"backbone": "hrnet_w48", "decoder": "hrnet_head",
                      "compute_dtype": "float32", "hrnet_width": 8, "hrnet_modules": [1, 1, 1],
                      "branch_conv": "pallas", "head_fuse": "up_first"}}


def _batch(n, h, w, seed, ncls=NCLS):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, ncls, (n, h, w)).astype(np.int32)
    label[:, : h // 8] = 255  # an ignored band
    label[-1] = 255  # a blank eval pad slot
    return {"image": (rng.rand(n, h, w, 3) * 255).astype(np.uint8), "label": label}


def jax_eval(cfg_raw, jmodel, params, stats, batch, monkeypatch):
    """The reference's ``make_evaluator`` -> (confusion matrix, summed
    probabilities NHWC), the latter read where the evaluator takes their
    argmax."""
    seen = []

    def argmax(a, axis=None):
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), a)
        return jnp.argmax(a, axis=axis)

    spy = {k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")}
    monkeypatch.setattr(jevaluator, "jnp", types.SimpleNamespace(**{**spy, "argmax": argmax}))
    step = jevaluator.make_evaluator(jconfig.config_from_dict(cfg_raw), jmodel)
    cm = np.asarray(step(params, stats, {k: jnp.asarray(v) for k, v in batch.items()}))
    jax.effects_barrier()
    monkeypatch.undo()
    assert len(seen) == 1
    return cm, seen[0]


def port_eval(cfg_raw, model, batch):
    """The port's evaluator -> (confusion matrix, summed probabilities NHWC)."""
    cfg = config.config_from_dict(cfg_raw)
    probs, step = evaluator.make_probs(cfg), evaluator.make_evaluator(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.eval()
    with torch.no_grad():
        cm = step(model, tb).numpy()
        prob = probs(model, tb).permute(0, 2, 3, 1).numpy()
    return cm, prob


def assert_confusion_agrees(cm, cm_ref, prob, prob_ref, label, ncls, tol=PROB_TOL):
    """Probabilities within ``tol``; confusion matrices equal except in
    pixels whose top-2 margin (of the reference's probabilities) is under
    ``tol``.  Returns the number of such pixels that moved."""
    np.testing.assert_allclose(prob, prob_ref, rtol=0, atol=tol)
    valid = label != 255
    pred, pred_ref = prob.argmax(-1), prob_ref.argmax(-1)
    # each matrix is the confusion of its own argmax
    np.testing.assert_array_equal(cm, np.asarray(jmetrics.confusion_matrix(
        pred, label, ncls, impl="bincount")))
    np.testing.assert_array_equal(cm_ref, np.asarray(jmetrics.confusion_matrix(
        pred_ref, label, ncls, impl="bincount")))
    top2 = np.sort(prob_ref, axis=-1)[..., -2:]
    moved = valid & (pred != pred_ref)
    assert np.all(top2[..., 1][moved] - top2[..., 0][moved] < tol), "a confident pixel moved"
    if not moved.any():
        np.testing.assert_array_equal(cm, cm_ref)
    return int(moved.sum())


def test_window_starts_snap_and_use_staged_match_the_reference():
    for size in (32, 64, 96, 100, 128, 257, 1024, 2048):
        for crop in (32, 64, 128, 1024):
            for stride in (16, 43, 96, 768):
                assert evaluator._window_starts(size, crop, stride) == \
                    jevaluator._window_starts(size, crop, stride)
    for v in (10.0, 48.0, 80.0, 144.0, 512.0, 1792.0, 1343.9):
        assert evaluator._snap(v) == jevaluator._snap(v)
    for mode in ("whole", "sliding"):
        for flip in (False, True):
            for scales in ([1.0], [0.75, 1.0], [0.5, 1.0, 1.5], [0.5, 0.75, 1.0, 1.25, 1.5, 1.75]):
                for impl in ("auto", "fused", "staged"):
                    raw = {"data": {"eval_mode": mode, "eval_flip": flip, "eval_scales": scales,
                                    "eval_impl": impl}}
                    assert evaluator.use_staged(config.config_from_dict(raw)) == \
                        jevaluator.use_staged(jconfig.config_from_dict(raw))


def _port_weights_as_reference(model, jmodel, seed):
    """Random BatchNorm affines and running statistics on the port's
    model (seeded numpy), and the same weights as the reference's trees
    (its structure from ``jax.eval_shape``: an HRNet init takes the CPU
    ~20 s to compile)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for k, t in model.state_dict().items():
            if "BatchNorm" in k or "fuse_norm" in k:
                if k.endswith("running_var"):
                    t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
                else:
                    t.add_(torch.from_numpy((0.1 * rng.randn(*t.shape)).astype(np.float32)))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3)), False))
    tmpl = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    flat = {k: v.numpy() for k, v in model.state_dict().items()}
    return jcompat.unflatten_torch_layout(flat, tmpl["params"], tmpl["batch_stats"])


@pytest.fixture(scope="module")
def hrnet_pair():
    jmodels = {b: JSeg(branch_conv=b, fuse_order="up_first") for b in ("pallas", "xla")}
    model = build_model(config.config_from_dict(_raw()))
    params, stats = _port_weights_as_reference(model, jmodels["xla"], 1)
    return jmodels, params, stats, model


HRNET_CASES = {
    # config 5's protocol at a small size: sliding on a non-square canvas,
    # flip and two scales -> the staged path ('auto'); branch 0 (H/4) is
    # eligible for the branch kernels in the 128^2 windows, and the
    # reference runs its Pallas kernels
    "sliding_flip_multiscale_staged": dict(
        jax_branch="pallas", canvas=(128, 192),
        data=dict(crop_size=128, eval_mode="sliding", eval_stride=96, eval_flip=True,
                  eval_scales=[0.75, 1.0])),
    "staged_window_batch": dict(
        canvas=(128, 160), data=dict(crop_size=128, eval_mode="sliding", eval_stride=96,
                                     eval_flip=True, eval_window_batch=3)),
    "sliding_fused": dict(
        canvas=(128, 160), data=dict(crop_size=128, eval_mode="sliding", eval_stride=96,
                                     eval_impl="fused")),
    "whole_multiscale_fused": dict(
        canvas=(128, 128), data=dict(crop_size=128, eval_scales=[0.75, 1.0])),
    "whole_eval_size": dict(
        canvas=(96, 96), data=dict(crop_size=128, eval_size=128)),
}


@pytest.mark.parametrize("case", sorted(HRNET_CASES))
def test_hrnet_evaluator_matches_the_reference(hrnet_pair, case, monkeypatch):
    jmodels, params, stats, model = hrnet_pair
    c = HRNET_CASES[case]
    raw = _raw(**c["data"])
    batch = _batch(2, *c["canvas"], seed=sorted(HRNET_CASES).index(case))
    jmodel = jmodels[c.get("jax_branch", "xla")]
    cm_ref, prob_ref = jax_eval(raw, jmodel, params, stats, batch, monkeypatch)
    cm, prob = port_eval(raw, model, batch)
    moved = assert_confusion_agrees(cm, cm_ref, prob, prob_ref, batch["label"], NCLS)
    print(f"{case}: max |dprob| {np.abs(prob - prob_ref).max():.3g}, {moved} pixels under "
          f"the margin moved, {cm.sum()} counted")
    assert cm.sum() == (batch["label"] != 255).sum()


def test_r50_pallas_stem_whole_flip_matches_the_reference(monkeypatch):
    """Config 3's eval protocol (whole image + flip, the fused path) on
    ResNet-50 + DeepLabV3+ with the stem through its kernel switch."""
    ncls = 4
    raw = {"data": {"dataset": "synthetic", "num_classes": ncls, "crop_size": 64,
                    "eval_flip": True},
           "model": {"backbone": "resnet50", "decoder": "deeplabv3plus", "output_stride": 16,
                     "compute_dtype": "float32", "stem_impl": "pallas"}}
    jmodel = jbuild(jconfig.config_from_dict(raw))
    model = build_model(config.config_from_dict(raw))
    params, stats = _port_weights_as_reference(model, jmodel, 4)
    batch = _batch(2, 64, 96, seed=11, ncls=ncls)
    cm_ref, prob_ref = jax_eval(raw, jmodel, params, stats, batch, monkeypatch)
    cm, prob = port_eval(raw, model, batch)
    moved = assert_confusion_agrees(cm, cm_ref, prob, prob_ref, batch["label"], ncls)
    print(f"r50: max |dprob| {np.abs(prob - prob_ref).max():.3g}, {moved} pixels moved")
