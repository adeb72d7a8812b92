"""The port's U-Net on ResNet-18 (config 1's and config 2's model) against
the JAX package's, in float32 from the same weights (``load_flax_variables``)
at crop 64, 2 images:

- the ``state_dict()`` keys are the reference's flattened keys;
- eval-mode and train-mode logits and the running statistics, under the
  bound of tests/test_torch_model.py (rtol 1e-3, atol 1e-3 max|v|);
- the whole gradient of a fixed cotangent, compared as one vector;
- ``stem_impl=pallas`` (kernels B and C; their plain versions here) against
  ``conv`` on the port: the same logits, statistics and gradient;
- the stem's max-pool gradient where window maxima tie (post-ReLU zeros in
  bf16): torch's routing equals the reference's ``reduce_window`` VJP
  (the cases of tests/test_pooling.py);
- ``model.pretrained`` from a random torchvision-layout ResNet-18 state
  dict: the same encoder weights through both packages (exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.methods import common as jcommon
from semi_supervised_semantic_segmentation_tpu.models.layers import max_pool_same_as_torch
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.test_torch_checkpoint import _assert_flat_equal, _jax_flat, _to_torchvision
from tests.test_torch_hrnet import _close_stats, _global_rel, _rel
from tests.torch_port_helpers import one_torch_thread

NCLS, CROP = 4, 64
RAW = {
    "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP},
    "model": {"backbone": "resnet18", "decoder": "unet", "output_stride": 32,
              "compute_dtype": "float32"},
    "method": {"name": "supervised"},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _cfg(**model):
    return config.config_from_dict({**RAW, "model": {**RAW["model"], **model}})


@pytest.fixture(scope="module")
def ref():
    jcfg = jconfig.config_from_dict(RAW)
    jmodel = jbuild(jcfg)
    params, stats = jcommon.init_model_variables(jcfg, jmodel, jax.random.key(0))
    rng = np.random.RandomState(0)
    x = rng.randn(2, CROP, CROP, 3).astype(np.float32)
    cot = rng.randn(2, CROP, CROP, NCLS).astype(np.float32)

    def loss(p):
        out, new_stats = jcommon.apply_train(jmodel, p, stats, jnp.asarray(x), jax.random.key(1))
        return jnp.vdot(out, jnp.asarray(cot)), (out, new_stats)

    grad_fn = jax.jit(jax.grad(loss, has_aux=True))
    grads, (logits, new_stats) = grad_fn(params)
    # the reference's own gradient from weights moved by 1e-7 (relative):
    # how far its gradient chaos alone carries it
    prng = np.random.RandomState(1)
    moved = jax.tree_util.tree_map(
        lambda a: a * (1.0 + 1e-7 * jnp.asarray(prng.randn(*a.shape), jnp.float32)), params)
    evals = jcommon.apply_eval(jmodel, params, stats, jnp.asarray(x))
    return dict(x=x, cot=cot, params=jax.device_get(params), stats=jax.device_get(stats),
                logits=np.asarray(logits), evals=np.asarray(evals),
                new_stats=jax.device_get(new_stats),
                grads=jcompat.flatten_params_to_torch_layout(jax.device_get(grads), {}),
                grads_moved=jcompat.flatten_params_to_torch_layout(
                    jax.device_get(grad_fn(moved)[0]), {}))


def _port(ref, **model):
    m = build_model(_cfg(**model))
    compat.load_flax_variables(m, ref["params"], ref["stats"])
    return m


def _train_run(ref, **model):
    """Train-mode logits (NHWC), state dict and named gradients of the
    reference's cotangent."""
    m = _port(ref, **model).train()
    logits = m(torch.from_numpy(ref["x"]))
    (logits * torch.from_numpy(ref["cot"]).permute(0, 3, 1, 2)).sum().backward()
    return (logits.detach().permute(0, 2, 3, 1).numpy(), m.state_dict(),
            {k: p.grad.numpy() for k, p in m.named_parameters()})


def test_state_dict_keys_are_the_flattened_reference_keys(ref):
    keys = set(build_model(_cfg()).state_dict())
    assert keys == set(jcompat.flatten_params_to_torch_layout(ref["params"], ref["stats"]))
    assert {"encoder.layer2_0.downsample.Conv_0.weight", "encoder.layer4_1.conv2.Conv_0.weight",
            "decoder.up0.conv1.Conv_0.weight", "decoder.up3.conv2.Norm_0.BatchNorm_0.running_var",
            "decoder.head.weight", "decoder.head.bias"} <= keys
    assert build_model(_cfg()).encoder.feature_channels == (64, 64, 128, 256, 512)


def test_eval_logits_match(ref):
    model = _port(ref).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(ref["x"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, NCLS, CROP, CROP)
    # f32 conv summation order differs between XLA:CPU and torch
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref["evals"]) < 1e-3


def test_train_logits_stats_and_gradient_match(ref):
    logits, sd, grads = _train_run(ref)
    assert _rel(logits, ref["logits"]) < 1e-3
    _close_stats(jcompat.flatten_params_to_torch_layout(ref["params"], ref["new_stats"]), sd)
    # The whole gradient as one vector, the reference's own gradient under
    # a 1e-7 weight move printed beside (measured 1.2e-5 and 7.3e-6): a
    # wrong layer, order or BatchNorm moves it by O(1).
    want = ref["grads"]
    assert set(grads) == set(want)
    rel, chaos = _global_rel(grads, want), _global_rel(ref["grads_moved"], want)
    print(f"gradient as one vector: port {rel:.3g} from the reference; the reference under "
          f"a 1e-7 weight move {chaos:.3g}")
    assert rel < 1e-3, (rel, chaos)


def test_pallas_stem_equals_conv_stem_in_the_port(ref):
    """Kernels B and C's plain versions in the model: the stem conv in f32
    with the BatchNorm folded from its own sums, against cuDNN's path."""
    lp, sp, gp = _train_run(ref, stem_impl="pallas")
    lc, sc, gc = _train_run(ref, stem_impl="conv")
    assert _rel(lp, lc) < 1e-4
    for k in sc:
        if "running_" in k:
            np.testing.assert_allclose(sp[k].numpy(), sc[k].numpy(), rtol=1e-4,
                                       atol=1e-4 * sc[k].abs().max().item(), err_msg=k)
    assert _global_rel(gp, gc) < 1e-3


def _pool_cases():
    rng = np.random.RandomState(0)
    smooth = rng.randn(2, 16, 24, 8).astype(np.float32)
    # quantized -> frequent exact ties inside windows
    tied = np.round(rng.randn(2, 16, 24, 8) * 2).astype(np.float32) / 2
    relu = np.maximum(rng.randn(2, 16, 24, 8), 0).astype(np.float32)
    return {"smooth": smooth, "tied": tied, "relu_zeros": relu}


@pytest.mark.parametrize("case", sorted(_pool_cases()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_gradient_ties_route_as_the_reference(case, dtype):
    """The stem's 3x3/s2/pad-1 max-pool: output and gradient bit-equal to
    the reference's (``max_pool_same_as_torch``, XLA's reduce_window VJP),
    ties included.  Dyadic cotangents make the sums exact, so equality is a
    pure routing check."""
    x = _pool_cases()[case]
    co = np.random.RandomState(1).randint(-16, 17, (2, 8, 12, 8)).astype(np.float32) / 4.0
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jy = max_pool_same_as_torch(jx)
    jg = jax.grad(lambda v: jnp.sum(max_pool_same_as_torch(v).astype(jnp.float32) * co))(jx)

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2).requires_grad_()
    ty = F.max_pool2d(tx, 3, 2, 1)
    (ty.float() * torch.from_numpy(co).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_array_equal(ty.detach().float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_array_equal(tx.grad.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jg, np.float32))


def test_r18_pretrained_encoder_import_matches_the_reference(tmp_path):
    fresh = build_model(_cfg())
    rng = np.random.RandomState(6)
    sd = {_to_torchvision(k): torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in fresh.encoder.state_dict().items()}
    assert "layer2.0.downsample.0.weight" in sd and "layer1.1.bn2.running_var" in sd
    sd.update({"fc.weight": torch.from_numpy(rng.randn(10, 512).astype(np.float32)),
               "fc.bias": torch.from_numpy(rng.randn(10).astype(np.float32))})
    sd.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(3)
               for k in list(sd) if k.endswith("running_var")})
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)

    model = build_model(_cfg(pretrained=path))
    jmodel = jbuild(jconfig.config_from_dict(RAW))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, CROP, CROP, 3)), False))
    tmpl = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    params, stats = jcompat.load_pretrained_encoder(path, tmpl["params"], tmpl["batch_stats"])
    want = {f"encoder.{k}": v for k, v in
            _jax_flat(params["encoder"], stats["encoder"]).items()}
    got = {k: v.numpy() for k, v in model.state_dict().items() if k.startswith("encoder.")}
    _assert_flat_equal(got, want)
    # the decoder keeps its seeded initialisation
    for k, v in fresh.decoder.state_dict().items():
        assert torch.equal(model.decoder.state_dict()[k], v), k
