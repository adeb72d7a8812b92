"""Config 1's step: the port's supervised method (U-Net on ResNet-18, crop
64, 2 images, float32) against the JAX step from the same weights and
batches for 3 steps, re-synchronising the weights before each step as
tests/test_torch_fixmatch.py does (the port's momentum carries over).
Augmentation is identity and U-Net has no dropout, so the steps draw
nothing.  Losses within rtol = atol = 2e-3, each tensor's update within 15
% of the reference's (relative norm), the learning rate within 1e-6
(relative)."""

import numpy as np
import pytest

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.methods import supervised as jsupervised
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.methods import get_method, supervised
from tests.torch_port_helpers import (
    identity_weak,
    one_torch_thread,
    steps_against_jax,
    uint8_batches,
)

CROP, NCLS, NL, STEPS = 64, 4, 2, 3
RAW = {
    "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP, "scale_min": 1.0,
             "scale_max": 1.0, "hflip_prob": 0.0},
    "model": {"backbone": "resnet18", "decoder": "unet", "output_stride": 32,
              "compute_dtype": "float32"},
    "method": {"name": "supervised"},
    "optim": {"lr": 0.05, "weight_decay": 1e-4},
    "train": {"labeled_batch_size": NL},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def test_supervised_steps_match_jax():
    assert get_method("supervised") is supervised
    assert not supervised.uses_unlabeled and not supervised.uses_ema
    jcfg = jconfig.config_from_dict(RAW)
    cols = ("loss", "sup_loss")
    jl, tl = steps_against_jax(
        jcfg, jbuild(jcfg), jsupervised, config.config_from_dict(RAW), supervised, STEPS,
        uint8_batches(STEPS, NL, CROP, NCLS, 1, True), None,
        lambda i: supervised.Draws(weak_l=identity_weak(NL), dropout=None), cols)
    # the reference suite's per-step loss tolerance
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(tl[:, 0], tl[:, 1])
