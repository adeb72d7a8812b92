"""Config 4's backbone: the port's ResNet-101 (+ DeepLabV3+, output stride
16) against the JAX package's, in float32:

- the state-dict keys and shapes against the reference's flattened
  variables, taken from ``jax.eval_shape`` (nothing compiled);
- one eval-mode forward at crop 32 from the reference's initialisation,
  carried across with ``load_flax_variables``: logits within 1e-3 of their
  max (f32 summation order differs between XLA:CPU and torch);
- ``model.pretrained``: a fabricated torchvision ResNet-101 state dict gives
  the same encoder through the reference's ``load_pretrained_encoder`` and
  the port's (exactly), and the decoder keeps its seeded initialisation.
"""

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
from tests.test_torch_checkpoint import _assert_flat_equal, _jax_flat, _to_torchvision
from tests.torch_port_helpers import one_torch_thread

CROP = 32
RAW = {
    "data": {"dataset": "synthetic", "num_classes": 19, "crop_size": CROP},
    "model": {"backbone": "resnet101", "decoder": "deeplabv3plus", "output_stride": 16,
              "compute_dtype": "float32"},
    "method": {"name": "cps"},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _shapes():
    jmodel = jbuild(jconfig.config_from_dict(RAW))
    v = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, CROP, CROP, 3)), False))
    return jmodel, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), v)


def test_state_dict_keys_and_shapes_are_the_reference_ones():
    _, tmpl = _shapes()
    want = jcompat.flatten_params_to_torch_layout(tmpl["params"], tmpl["batch_stats"])
    model = build_model(config.config_from_dict(RAW))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    # 3 + 4 + 23 + 3 bottlenecks, dilated layer4 (output stride 16)
    assert {f"layer{s}_{b}" for s, n in ((1, 3), (2, 4), (3, 23), (4, 3)) for b in range(n)} \
        == {k.split(".")[1] for k in got if k.startswith("encoder.layer")}
    assert model.encoder.layer4_1.conv2.Conv_0.dilation == (2, 2)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for k, s in got.items() if "running_" not in k)


def test_eval_logits_match():
    jcfg = jconfig.config_from_dict(RAW)
    jmodel = jbuild(jcfg)
    params, stats = jcommon.init_model_variables(jcfg, jmodel, jax.random.key(0))
    x = np.random.RandomState(0).randn(2, CROP, CROP, 3).astype(np.float32)
    want = np.asarray(jcommon.apply_eval(jmodel, params, stats, jnp.asarray(x)))
    model = build_model(config.config_from_dict(RAW))
    compat.load_flax_variables(model, jax.device_get(params), jax.device_get(stats))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, CROP, CROP, 19)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_torchvision_resnet101_names_match_the_reference(tmp_path):
    fresh = build_model(config.config_from_dict(RAW))
    rng = np.random.RandomState(6)
    sd = {_to_torchvision(k): torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in fresh.encoder.state_dict().items()}
    assert "layer3.22.conv3.weight" in sd and "layer4.0.downsample.1.running_var" in sd
    sd["fc.weight"] = torch.zeros(10, 2048)
    sd.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(3)
               for k in list(sd) if k.endswith("running_var")})
    path = str(tmp_path / "resnet101.pth")
    torch.save(sd, path)

    model = build_model(config.config_from_dict({**RAW, "model": {**RAW["model"],
                                                                  "pretrained": path}}))
    _, tmpl = _shapes()
    params, stats = jcompat.load_pretrained_encoder(path, tmpl["params"], tmpl["batch_stats"])
    want = {f"encoder.{k}": v for k, v in
            _jax_flat(params["encoder"], stats["encoder"]).items()}
    got = {k: v.numpy() for k, v in model.state_dict().items() if k.startswith("encoder.")}
    _assert_flat_equal(got, want)
    for k, v in fresh.decoder.state_dict().items():
        assert torch.equal(model.decoder.state_dict()[k], v), k
