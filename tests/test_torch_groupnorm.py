"""``model.norm: groupnorm`` in the port (``…_torch/models/layers.py``
``GroupNorm`` / ``Norm``) against the JAX package's ``Norm`` (flax 0.12's
``nn.GroupNorm(num_groups=min(32, C), dtype=compute, param_dtype=f32)``):

- the module at C = 16 and 64 on NHWC -> NCHW inputs: float32 output
  within 2e-6 (relative to its largest value) and its input and parameter
  gradients within 1e-5; bfloat16 output within one bf16 ulp of each
  element.  At C = 48 both refuse: 32 groups do not divide 48 channels;
- U-Net/ResNet-18 with GroupNorm from the reference's weights (crop 64,
  float32): the logits within 1e-3 (relative to their largest value) in
  train and in eval mode, which agree exactly (no batch statistics), and
  the whole gradient of a fixed cotangent, as one vector, within 1e-3;
- 2 supervised steps and 2 Mean-Teacher steps (its EMA over a teacher
  with no buffers; at step 0 teacher and student agree, GroupNorm having
  no batch statistics, so the consistency is 0 there (to 1e-9) and
  positive at step 1) from re-synced weights, at tests/test_torch_supervised.py's and
  tests/test_torch_mean_teacher.py's bounds;
- ``stem_impl=pallas`` with GroupNorm takes the plain conv + norm path, as
  the reference's ``PallasStemSegment`` does: kernel B's plain version is
  not called (it is with BatchNorm), and the logits equal ``conv``'s;
- reference-layout checkpoints with ``GroupNorm_0`` keys and no running
  statistics: the reference's file into the port and the port's into the
  reference, exactly, the momentum buffers in the reference's parameter
  order (a module's weight before its bias);
- where the reference fails, the port raises: DeepLabV3+ and HRNet-W48
  with "Number of groups (32) does not divide the number of channels
  (48)", and ``model.pretrained`` (a BatchNorm encoder file) with a
  ``KeyError`` naming a ``GroupNorm_0`` parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.methods import common as jcommon
from semi_supervised_semantic_segmentation_tpu.methods import mean_teacher as jmean_teacher
from semi_supervised_semantic_segmentation_tpu.methods import supervised as jsupervised
from semi_supervised_semantic_segmentation_tpu.models.layers import Norm as JNorm
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.methods import mean_teacher, supervised
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.models.layers import Norm
from semi_supervised_semantic_segmentation_tpu_torch.ops import stem
from tests.test_torch_checkpoint import (
    _assert_flat_equal,
    _jax_flat,
    _jax_momentum,
    _to_torchvision,
)
from tests.test_torch_hrnet import _global_rel, _rel
from tests.torch_port_helpers import (
    identity_strong,
    identity_weak,
    one_torch_thread,
    steps_against_jax,
    uint8_batches,
)

NCLS, CROP, NL, NU = 4, 64, 2, 2
GROUPS_48 = "Number of groups (32) does not divide the number of channels (48)"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _raw(method="supervised", **model):
    return {"data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP,
                     "scale_min": 1.0, "scale_max": 1.0, "hflip_prob": 0.0, "jitter_prob": 0.0,
                     "grayscale_prob": 0.0, "blur_prob": 0.0},
            "model": {"backbone": "resnet18", "decoder": "unet", "output_stride": 32,
                      "compute_dtype": "float32", "norm": "groupnorm", **model},
            "method": ({"name": method, "ema_alpha": 0.9, "rampup_iters": 0}
                       if method == "mean_teacher" else {"name": method}),
            "optim": {"lr": 0.05, "weight_decay": 1e-4},
            "train": {"labeled_batch_size": NL, "unlabeled_batch_size": NU}}


def _jnorm(x, scale, bias, dtype):
    return JNorm("groupnorm", dtype=dtype).apply(
        {"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}, x)


@pytest.mark.parametrize("channels", [16, 48, 64])
def test_groupnorm_module_matches_flax(channels):
    rng = np.random.RandomState(channels)
    # a variance near 1e-4, so that epsilon (1e-6, not torch's 1e-5) shows
    x = (rng.randn(2, 6, 5, channels) * 0.01 + 0.005).astype(np.float32)
    scale = (rng.rand(channels) + 0.5).astype(np.float32)
    bias = rng.randn(channels).astype(np.float32)
    if channels % min(32, channels):
        with pytest.raises(ValueError, match=GROUPS_48.replace("(", r"\(").replace(")", r"\)")):
            _jnorm(jnp.asarray(x), scale, bias, jnp.float32)
        with pytest.raises(ValueError, match=r"model.norm='groupnorm': Number of groups \(32\)"):
            Norm(channels, kind="groupnorm")
        return
    mod = Norm(channels, kind="groupnorm")
    assert [n for n, _ in mod.named_parameters()] == ["GroupNorm_0.weight", "GroupNorm_0.bias"]
    assert not list(mod.buffers()) and mod.GroupNorm_0.groups == min(32, channels)
    with torch.no_grad():
        mod.GroupNorm_0.weight.copy_(torch.from_numpy(scale))
        mod.GroupNorm_0.bias.copy_(torch.from_numpy(bias))

    # float32: output and the VJP of a fixed cotangent
    cot = rng.randn(*x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, s, b: _jnorm(a, s, b, jnp.float32), jnp.asarray(x),
                        jnp.asarray(scale), jnp.asarray(bias))
    wx, ws, wb = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = mod(xt)
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert _rel(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want)) < 2e-6
    for t, w in ((xt.grad.permute(0, 2, 3, 1), wx), (mod.GroupNorm_0.weight.grad, ws),
                 (mod.GroupNorm_0.bias.grad, wb)):
        assert _rel(t.numpy(), np.asarray(w)) < 1e-5

    # bfloat16 in, bfloat16 out, within one bf16 ulp of each element
    want16 = np.asarray(_jnorm(jnp.asarray(x).astype(jnp.bfloat16), scale, bias,
                               jnp.bfloat16).astype(jnp.float32))
    with torch.no_grad():
        got16 = mod(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16
    got16 = got16.float().permute(0, 2, 3, 1).numpy()
    assert np.all(np.abs(got16 - want16) <= 2.0 ** -7 * np.abs(want16) + 1e-30)


@pytest.fixture(scope="module")
def ref():
    jcfg = jconfig.config_from_dict(_raw())
    jmodel = jbuild(jcfg)
    params, stats = jcommon.init_model_variables(jcfg, jmodel, jax.random.key(0))
    assert not stats
    rng = np.random.RandomState(0)
    x = rng.randn(2, CROP, CROP, 3).astype(np.float32)
    cot = rng.randn(2, CROP, CROP, NCLS).astype(np.float32)

    def loss(p):
        out, _ = jcommon.apply_train(jmodel, p, stats, jnp.asarray(x), jax.random.key(1))
        return jnp.vdot(out, jnp.asarray(cot)), out

    grads, logits = jax.jit(jax.grad(loss, has_aux=True))(params)
    return dict(x=x, cot=cot, params=jax.device_get(params), logits=np.asarray(logits),
                evals=np.asarray(jcommon.apply_eval(jmodel, params, stats, jnp.asarray(x))),
                grads=jcompat.flatten_params_to_torch_layout(jax.device_get(grads), {}))


def _port(ref, **model):
    m = build_model(config.config_from_dict(_raw(**model)))
    compat.load_flax_variables(m, ref["params"], {})
    return m


def test_unet_r18_logits_and_gradient_match(ref):
    m = _port(ref)
    keys = set(m.state_dict())
    assert keys == set(jcompat.flatten_params_to_torch_layout(ref["params"], {}))
    assert "encoder.stem.Norm_0.GroupNorm_0.weight" in keys
    assert not any("BatchNorm" in k or "running_" in k for k in keys)
    x = torch.from_numpy(ref["x"])
    logits = m.train()(x)
    (logits * torch.from_numpy(ref["cot"]).permute(0, 3, 1, 2)).sum().backward()
    with torch.no_grad():
        evals = m.eval()(x)
    assert torch.equal(evals, logits.detach())
    assert _rel(logits.detach().permute(0, 2, 3, 1).numpy(), ref["logits"]) < 1e-3
    assert _rel(evals.permute(0, 2, 3, 1).numpy(), ref["evals"]) < 1e-3
    grads = {k: p.grad.numpy() for k, p in m.named_parameters()}
    rel = _global_rel(grads, ref["grads"])
    print(f"gradient as one vector: port {rel:.3g} from the reference")
    assert rel < 1e-3


def test_pallas_stem_takes_the_plain_path_under_groupnorm(ref, monkeypatch):
    calls = []
    plain = stem.stem_fwd_plain
    monkeypatch.setattr(stem, "stem_fwd_plain", lambda *a: calls.append(1) or plain(*a))
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        got = _port(ref, stem_impl="pallas").train()(x)
        want = _port(ref, stem_impl="conv").train()(x)
    assert not calls and torch.equal(got, want)
    bn = build_model(config.config_from_dict(_raw(norm="batchnorm", stem_impl="pallas")))
    with torch.no_grad():
        bn.train()(x)
    assert calls


def test_supervised_steps_match_jax():
    raw = _raw()
    jcfg = jconfig.config_from_dict(raw)
    jl, tl = steps_against_jax(
        jcfg, jbuild(jcfg), jsupervised, config.config_from_dict(raw), supervised, 2,
        uint8_batches(2, NL, CROP, NCLS, 1, True), None,
        lambda i: supervised.Draws(weak_l=identity_weak(NL), dropout=None), ("loss", "sup_loss"))
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)


def test_mean_teacher_steps_match_jax():
    raw = _raw("mean_teacher")
    jcfg = jconfig.config_from_dict(raw)
    jl, tl = steps_against_jax(
        jcfg, jbuild(jcfg), jmean_teacher, config.config_from_dict(raw), mean_teacher, 2,
        uint8_batches(2, NL, CROP, NCLS, 1, True), uint8_batches(2, NU, CROP, NCLS, 2, False),
        lambda i: mean_teacher.Draws(weak_l=identity_weak(NL), weak_u=identity_weak(NU),
                                     strong=identity_strong(NU), dropout=None),
        ("loss", "sup_loss", "unsup_loss"), teacher_bound=5e-3)
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)
    print(f"consistency loss, reference {jl[:, 2]}, port {tl[:, 2]}")
    assert max(jl[0, 2], tl[0, 2]) < 1e-9 and min(jl[1, 2], tl[1, 2]) > 1e-6


def test_reference_layout_checkpoints_both_ways(tmp_path):
    raw = _raw("mean_teacher")
    jcfg, cfg = jconfig.config_from_dict(raw), config.config_from_dict(raw)
    jmodel = jbuild(jcfg)
    jstate = jax.device_get(jmean_teacher.init_state(jcfg, jmodel, jax.random.key(0), 10))
    jstate = jstate.replace(ema_params=jax.tree.map(lambda a: np.asarray(a) + 0.5,
                                                    jstate.ema_params))
    src = str(tmp_path / "ref.pth")
    jcompat.export_reference_checkpoint(src, jstate, {"epoch": 3}, cfg=jcfg)
    state = mean_teacher.init_state(cfg, build_model(cfg), 10)
    assert compat.import_reference_checkpoint(src, state)["epoch"] == 3
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    assert any(".GroupNorm_0.weight" in k for k in sd)
    assert not any("running_" in k or "BatchNorm" in k for k in sd)
    _assert_flat_equal(sd, _jax_flat(jstate.params, {}))
    _assert_flat_equal({k: v.numpy() for k, v in state.ema_model.state_dict().items()},
                       _jax_flat(jstate.ema_params, {}))
    order = compat.reference_param_order(state.model)
    assert order.index("encoder.stem.Norm_0.GroupNorm_0.weight") + 1 == \
        order.index("encoder.stem.Norm_0.GroupNorm_0.bias")

    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for b in compat._named_buffers(state).values():
            b.copy_(torch.randn(b.shape, generator=g))
    state.step = 4
    path = str(tmp_path / "port.pth")
    compat.export_reference_checkpoint(path, state, {"epoch": 1}, cfg)
    moved = lambda t: jax.tree.map(lambda a: np.asarray(a) + 1.0, t)  # noqa: E731
    template = jstate.replace(params=moved(jstate.params), ema_params=moved(jstate.ema_params))
    restored = jax.device_get(jcompat.import_reference_checkpoint(path, template))
    assert int(restored.step) == 4
    _assert_flat_equal(_jax_flat(restored.params, {}),
                       {k: v.numpy() for k, v in state.model.state_dict().items()})
    _assert_flat_equal(_jax_flat(restored.ema_params, {}),
                       {k: v.numpy() for k, v in state.ema_model.state_dict().items()})
    _assert_flat_equal(_jax_momentum(restored),
                       {k: v.numpy() for k, v in compat._named_buffers(state).items()})
    fresh = mean_teacher.init_state(cfg, build_model(cfg, seed=9), 10)
    compat.import_reference_checkpoint(path, fresh)
    for a, b in ((state.model, fresh.model), (state.ema_model, fresh.ema_model)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k


@pytest.mark.parametrize("model", [
    {"decoder": "deeplabv3plus", "output_stride": 16},
    {"backbone": "hrnet_w48", "decoder": "hrnet_head"},
])
def test_groupnorm_refused_where_the_reference_fails(model):
    raw = _raw(**model)
    jmodel = jbuild(jconfig.config_from_dict(raw))
    with pytest.raises(ValueError, match=r"does not divide the number of channels \(48\)") as e:
        jmodel.init(jax.random.key(0), jnp.zeros((1, CROP, CROP, 3)), False)
    assert GROUPS_48 in str(e.value)
    with pytest.raises(ValueError) as e:
        build_model(config.config_from_dict(raw))
    assert "model.norm='groupnorm'" in str(e.value) and GROUPS_48 in str(e.value)


def test_pretrained_batchnorm_encoder_is_refused_under_groupnorm(tmp_path):
    bn = build_model(config.config_from_dict(_raw(norm="batchnorm")))
    rng = np.random.RandomState(6)
    sd = {_to_torchvision(k): torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in bn.encoder.state_dict().items()}
    path = str(tmp_path / "r18.pth")
    torch.save(sd, path)
    raw = _raw()
    jmodel = jbuild(jconfig.config_from_dict(raw))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, CROP, CROP, 3)),
                                                False))
    tmpl = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    with pytest.raises(KeyError, match="GroupNorm_0"):
        jcompat.load_pretrained_encoder(path, tmpl["params"], {})
    with pytest.raises(KeyError, match="GroupNorm_0"):
        build_model(config.config_from_dict({**raw, "model": {**raw["model"], "pretrained": path}}))
