"""``model.remat: blocks`` on the port's ResNet (``…_torch/models/resnet.py``):
each residual block checkpointed in training (``layers.checkpoint``), the
stem outside, as the reference's ``nn.remat(block_cls)``.

- Remat changes memory, never values (the rule of tests/test_models.py for
  HRNet's plans): in float64, one train-mode step with ``blocks`` equals one
  without it -- the loss, every gradient, every BatchNorm running statistic
  and every parameter after an SGD update -- within 1e-12 (relative to each
  tensor's largest element), on U-Net/ResNet-18 and DeepLabV3+/ResNet-50
  (dropout from a fixed keep-mask).  Each block's forward runs twice under
  ``blocks`` (the backward's re-run) and once without; the stem once.
  A re-run that updated the running statistics again would move them by
  about 0.1 of themselves.
- Eval mode, and train mode under ``torch.no_grad``, checkpoint nothing.
- The port against the reference, both with ``blocks``: 2 supervised steps
  on U-Net/ResNet-18 (crop 64, float32) from re-synced weights, at
  tests/test_torch_supervised.py's bounds (losses rtol = atol = 2e-3, each
  update within 15 % of the reference's).
- The plans the reference refuses on a ResNet stay refused.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.methods import supervised as jsupervised
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine.state import SGD
from semi_supervised_semantic_segmentation_tpu_torch.methods import supervised
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.models.registry import SegModel
from tests.torch_port_helpers import (
    identity_weak,
    one_torch_thread,
    steps_against_jax,
    uint8_batches,
)

NCLS, CROP, N = 4, 64, 2
MODELS = {
    "unet_r18": {"backbone": "resnet18", "decoder": "unet", "output_stride": 32},
    "dlv3p_r50": {"backbone": "resnet50", "decoder": "deeplabv3plus", "output_stride": 16},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _raw(model: str, remat: str, **extra):
    return {"data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP,
                     "scale_min": 1.0, "scale_max": 1.0, "hflip_prob": 0.0},
            "model": {**MODELS[model], "compute_dtype": "float32", "remat": remat, **extra},
            "method": {"name": "supervised"},
            "optim": {"lr": 0.05, "weight_decay": 1e-4},
            "train": {"labeled_batch_size": N}}


def _count_forwards(model):
    """Forward pre-hooks counting the calls of the stem and of every block
    (a re-run stops once it has rebuilt what the backward needs, before any
    forward hook)."""
    counts = {}
    enc = model.encoder
    names = ["stem"] + [f"layer{s + 1}_{b}" for s in range(4) for b in range(enc.layers[s])]
    for name in names:
        counts[name] = 0
        getattr(enc, name).register_forward_pre_hook(
            lambda mod, args, name=name: counts.__setitem__(name, counts[name] + 1))
    return counts


def _f64_step(model_name: str, remat: str):
    cfg = config.config_from_dict(_raw(model_name, remat))
    model = build_model(cfg, seed=3).double()
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    counts = _count_forwards(model)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(N, CROP, CROP, 3))
    y = torch.from_numpy(rng.randint(0, NCLS, (N, CROP, CROP)))
    keep = model.dropout_mask(N, CROP, CROP, torch.Generator().manual_seed(1))
    model.train()
    loss = F.cross_entropy(model(x, keep), y)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    SGD(cfg, model, 10).step(0)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return float(loss.detach()), grads, buffers, params, counts


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_blocks_step_equals_no_remat_in_float64(model_name):
    (l0, g0, b0, p0, c0), (l1, g1, b1, p1, c1) = (_f64_step(model_name, r)
                                                  for r in ("none", "blocks"))
    assert l1 == pytest.approx(l0, rel=1e-12, abs=0)
    for want, got in ((g0, g1), (b0, b1), (p0, p1)):
        assert set(want) == set(got)
        for k in want:
            err = float((got[k] - want[k]).abs().max())
            assert err <= 1e-12 * max(float(want[k].abs().max()), 1e-30), (k, err)
    assert any(k.endswith("running_mean") for k in b0)
    assert c0["stem"] == c1["stem"] == 1
    assert all(v == 1 for k, v in c0.items())
    assert all(v == 2 for k, v in c1.items() if k != "stem"), c1


def test_eval_and_no_grad_keep_no_checkpoint():
    model = build_model(config.config_from_dict(_raw("unet_r18", "blocks")))
    assert model.encoder.remat
    counts = _count_forwards(model)
    x = torch.rand(N, CROP, CROP, 3)
    model.eval()
    model(x).float().sum().backward()
    assert all(v == 1 for v in counts.values()), counts
    model.train()
    with torch.no_grad():
        model(x)
    assert all(v == 2 for v in counts.values()), counts


def test_blocks_supervised_steps_match_the_reference_with_blocks():
    raw = _raw("unet_r18", "blocks")
    jcfg = jconfig.config_from_dict(raw)
    assert jbuild(jcfg).remat == "blocks"
    steps = 2
    jl, tl = steps_against_jax(
        jcfg, jbuild(jcfg), jsupervised, config.config_from_dict(raw), supervised, steps,
        uint8_batches(steps, N, CROP, NCLS, 1, True), None,
        lambda i: supervised.Draws(weak_l=identity_weak(N), dropout=None), ("loss", "sup_loss"))
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("plan", ["stages:3", "branches", "branches:2,3"])
def test_hrnet_plans_stay_refused_on_a_resnet(plan):
    raw = _raw("unet_r18", plan)
    with pytest.raises(ValueError, match="HRNet-only"):
        jconfig.config_from_dict(raw)
    with pytest.raises(ValueError, match="HRNet-only"):
        config.config_from_dict(raw)
    with pytest.raises(ValueError, match="HRNet-only"):
        SegModel("resnet18", "unet", remat=plan)
