"""Port's ResNet-50 + DeepLabV3+ against the JAX model at crop 64 in float32,
from the same weights (``load_flax_variables``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.methods import common as jcommon
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.torch_port_helpers import capture_dropout_masks, nhwc_keep_to_nchw

RAW = {
    "data": {"dataset": "synthetic", "num_classes": 5, "crop_size": 64},
    "model": {"backbone": "resnet50", "decoder": "deeplabv3plus", "output_stride": 16,
              "compute_dtype": "float32"},
    "method": {"name": "fixmatch_cutmix"},
}


@pytest.fixture(scope="module")
def ref():
    jcfg = jconfig.config_from_dict(RAW)
    jmodel = jbuild(jcfg)
    params, stats = jcommon.init_model_variables(jcfg, jmodel, jax.random.key(0))
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    return jmodel, jax.device_get(params), jax.device_get(stats), x


def _port(ref):
    _, params, stats, _ = ref
    model = build_model(config.config_from_dict(RAW))
    compat.load_flax_variables(model, params, stats)
    return model


def _assert_logits_close(got_nchw, want_nhwc):
    # f32 conv summation order differs between XLA:CPU and torch
    got = got_nchw.detach().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want_nhwc)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_state_dict_keys_are_the_flattened_reference_keys(ref):
    _, params, stats, _ = ref
    keys = set(build_model(config.config_from_dict(RAW)).state_dict())
    assert keys == set(jcompat.flatten_params_to_torch_layout(params, stats))
    assert {"encoder.stem.Conv_0.weight", "decoder.fuse1a.weight", "decoder.fuse1b.weight",
            "encoder.layer1_0.conv1.Norm_0.BatchNorm_0.running_var"} <= keys
    assert not any(k.endswith("num_batches_tracked") for k in keys)


def test_eval_logits_match(ref):
    jmodel, params, stats, x = ref
    want = jcommon.apply_eval(jmodel, params, stats, jnp.asarray(x))
    model = _port(ref).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _assert_logits_close(got, want)


@pytest.mark.parametrize("stem_impl", ["conv", "pallas"])
def test_train_forward_logits_and_bn_stats_match(ref, stem_impl):
    """One train-mode forward (batch statistics, ASPP dropout with the
    reference's own mask) gives the same logits and running statistics.
    The port's stem impls are the same function; at crop 64 the reference
    runs its plain stem (the TPU kernel needs W/2 % 128 == 0)."""
    jmodel, params, stats, x = ref
    masks = []
    with capture_dropout_masks(masks):
        want, new_stats = jcommon.apply_train(jmodel, params, stats, jnp.asarray(x),
                                              jax.random.key(1))
    jax.effects_barrier()
    assert len(masks) == 1 and 0.3 < masks[0].mean() < 0.8
    model = _port(ref)
    model.encoder.stem.impl = stem_impl
    model.train()
    got = model(torch.from_numpy(x), torch.from_numpy(nhwc_keep_to_nchw(masks[0])))
    _assert_logits_close(got, want)
    flat = jcompat.flatten_params_to_torch_layout(params, jax.device_get(new_stats))
    sd = model.state_dict()
    for k, v in flat.items():
        if "running_" in k:
            # the logits' bound, per tensor: f32 conv order and one-pass
            # (reference) vs Welford (torch) batch variance
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-3,
                                       atol=1e-3 * np.abs(v).max(), err_msg=k)
