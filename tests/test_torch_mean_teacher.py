"""Config 2's step: the port's Mean Teacher (``methods/mean_teacher.py``)
and its consistency loss (``ops/losses.py::mse_consistency``) against the
JAX package's:

- ``mse_consistency`` for both reductions, with and without the valid
  mask, within rtol 1e-6 (float32);
- 3 Mean-Teacher steps on U-Net/ResNet-18 (crop 64, 2 + 2 images, float32)
  from the same weights and batches, re-synchronising weights and teacher
  before each step as tests/test_torch_fixmatch.py does: losses within
  rtol = atol = 2e-3, each tensor's update within 15 % of the reference's,
  the learning rate within 1e-6 (relative), the teacher within 5e-3 on
  every tensor, and a consistency loss above 0.  Augmentation is identity
  and U-Net has no dropout, so the steps draw nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.methods import mean_teacher as jmean_teacher
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu.ops import losses as jlosses
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.methods import get_method, mean_teacher
from semi_supervised_semantic_segmentation_tpu_torch.ops import losses
from tests.torch_port_helpers import (
    identity_strong,
    one_torch_thread,
    identity_weak,
    steps_against_jax,
    uint8_batches,
)

CROP, NCLS, NL, NU, STEPS = 64, 4, 2, 2, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "classes"])
def test_mse_consistency_matches_jax(reduction, masked):
    rng = np.random.RandomState(0)
    s = (rng.randn(2, 16, 12, 5) * 3).astype(np.float32)
    t = (rng.randn(2, 16, 12, 5) * 3).astype(np.float32)
    mask = rng.rand(2, 16, 12) < 0.7 if masked else None
    want = float(jlosses.mse_consistency(jnp.asarray(s), jnp.asarray(t),
                                         None if mask is None else jnp.asarray(mask), reduction))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    got = float(losses.mse_consistency(nchw(s), nchw(t),
                                       None if mask is None else torch.from_numpy(mask),
                                       reduction))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mse_consistency_all_masked_is_zero():
    x = torch.randn(1, 3, 4, 4)
    for reduction in ("mean", "classes"):
        assert float(losses.mse_consistency(x, -x, torch.zeros(1, 4, 4, dtype=torch.bool),
                                            reduction)) == 0.0
    with pytest.raises(ValueError, match="reduction"):
        losses.mse_consistency(x, x, None, "sum")


@pytest.mark.parametrize("reduction", ["mean", "classes"])
def test_mean_teacher_steps_match_jax(reduction):
    assert get_method("mean_teacher") is mean_teacher
    assert mean_teacher.uses_unlabeled and mean_teacher.uses_ema
    raw = {
        "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP,
                 "scale_min": 1.0, "scale_max": 1.0, "hflip_prob": 0.0, "jitter_prob": 0.0,
                 "grayscale_prob": 0.0, "blur_prob": 0.0},
        "model": {"backbone": "resnet18", "decoder": "unet", "output_stride": 32,
                  "compute_dtype": "float32"},
        "method": {"name": "mean_teacher", "ema_alpha": 0.99, "rampup_iters": 2,
                   "consistency_weight": 10.0, "consistency_reduction": reduction},
        "optim": {"lr": 0.05, "weight_decay": 1e-4},
        "train": {"labeled_batch_size": NL, "unlabeled_batch_size": NU},
    }
    jcfg = jconfig.config_from_dict(raw)
    cols = ("loss", "sup_loss", "unsup_loss", "consistency_weight")
    jl, tl = steps_against_jax(
        jcfg, jbuild(jcfg), jmean_teacher, config.config_from_dict(raw), mean_teacher, STEPS,
        uint8_batches(STEPS, NL, CROP, NCLS, 1, True),
        uint8_batches(STEPS, NU, CROP, NCLS, 2, False),
        lambda i: mean_teacher.Draws(weak_l=identity_weak(NL), weak_u=identity_weak(NU),
                                     strong=identity_strong(NU), dropout=None),
        cols, teacher_bound=5e-3)
    assert np.all(jl[:, 2] > 0) and np.all(tl[:, 2] > 0)
    assert jl[0, 3] < jl[1, 3] < jl[2, 3] == 10.0  # the sigmoid ramp, then its weight
    # the reference suite's per-step loss tolerance
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)
