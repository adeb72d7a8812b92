"""The slice as a whole: the port's FixMatch + CutMix step (R50 +
DeepLabV3+, crop 64, 2 + 2 images, float32) against the JAX step from the
same weights and batches, for 3 steps; and the port's SGD and EMA against
the reference's optax chain.

As in tests/test_reference_trajectory.py, augmentation is identity, so the
only random draws are the CutMix box (replayed from the JAX step's key
structure) and the ASPP dropout mask (read from the JAX step as it runs);
both are injected into the port.  Both sides run CutMix through their
kernel switch (``data.cutmix_impl=pallas``: interpret mode there, the plain
version here), except that the reference's kernel draws its own box, so
the JAX side uses its XLA CutMix with the replayed box.

Why every port step starts from the reference's state: a randomly
initialised R50 + DeepLabV3+ at crop 64 is numerically chaotic.  Its ASPP
image-pool BatchNorm normalizes over only N values per channel and layer4
sees 4x4 maps, so perturbing the JAX parameters by 1e-7 (relative) moves
JAX's own one-step update by up to 5.5% per tensor (relative norm), and the
port's update differs from JAX's by the same 5.4%.  A free-running
trajectory therefore drifts apart within two steps for reasons that are
not the port's; re-synchronising the weights (parameters, BN statistics and
the teacher) before each step keeps every step comparable while the port's
own momentum buffers carry over from step to step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.methods import fixmatch as jfixmatch
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.methods import fixmatch
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.torch_port_helpers import (
    capture_dropout_masks,
    identity_draws,
    nhwc_keep_to_nchw,
    replay_cutmix_boxes,
)

CROP, NCLS, NL, NU, STEPS = 64, 4, 2, 2, 3
RAW = {
    "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP, "scale_min": 1.0,
             "scale_max": 1.0, "hflip_prob": 0.0, "jitter_prob": 0.0, "grayscale_prob": 0.0,
             "blur_prob": 0.0},
    "model": {"backbone": "resnet50", "decoder": "deeplabv3plus", "output_stride": 16,
              "compute_dtype": "float32"},
    "method": {"name": "fixmatch_cutmix", "conf_thresh": 0.3, "ema_alpha": 0.99,
               "rampup_iters": 10, "cutmix_prob": 1.0},
    "optim": {"lr": 0.05, "weight_decay": 1e-4},
    "train": {"labeled_batch_size": NL, "unlabeled_batch_size": NU},
}


def _batches(batch, seed, labeled):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        image = (rng.rand(batch, CROP, CROP, 3) * 255).astype(np.uint8)
        if labeled:
            label = rng.randint(0, NCLS, (batch, CROP, CROP)).astype(np.int32)
            label[rng.rand(batch, CROP, CROP) < 0.1] = 255
        else:
            label = np.full((batch, CROP, CROP), 255, np.int32)
        out.append({"image": image, "label": label,
                    "size": np.full((batch, 2), CROP, np.int32)})
    return out


def _close(flat, sd, bound):
    """Per-tensor relative drift max|a-b| / max(max|a|, 0.1)
    (tests/test_reference_trajectory.py::_tensors_close)."""
    for k, v in flat.items():
        rel = np.max(np.abs(v - sd[k].numpy())) / max(np.max(np.abs(v)), 0.1)
        assert rel < bound, (k, rel)


def _flat(params, stats):
    return jcompat.flatten_params_to_torch_layout(jax.device_get(params), jax.device_get(stats))


def test_fixmatch_steps_match_jax():
    jcfg = jconfig.config_from_dict(RAW)
    jmodel = jbuild(jcfg)
    jstate = jfixmatch.init_state(jcfg, jmodel, jax.random.key(0), STEPS)
    jstep = jax.jit(jfixmatch.make_train_step(jcfg, jmodel, STEPS))
    rng0 = np.asarray(jax.device_get(jstate.rng))

    cfg = config.config_from_dict({**RAW, "data": {**RAW["data"], "cutmix_impl": "pallas"}})
    state = fixmatch.init_state(cfg, build_model(cfg), STEPS)
    step = fixmatch.make_train_step(cfg, STEPS)

    lab, unlab = _batches(NL, 1, True), _batches(NU, 2, False)
    cols = ("loss", "sup_loss", "unsup_loss")
    jl, tl = [], []
    masks = []
    with capture_dropout_masks(masks):
        for i in range(STEPS):
            compat.load_flax_variables(state.model, jax.device_get(jstate.params),
                                       jax.device_get(jstate.batch_stats))
            compat.load_flax_variables(state.ema_model, jax.device_get(jstate.ema_params),
                                       jax.device_get(jstate.ema_batch_stats))
            before = _flat(jstate.params, {})
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in lab[i].items()},
                               {k: jnp.asarray(v) for k, v in unlab[i].items()})
            jl.append([float(jm[c]) for c in cols])
            jax.effects_barrier()
            assert len(masks) == i + 1
            draws = identity_draws(NL, NU, replay_cutmix_boxes(rng0, i, NU, CROP),
                                   torch.from_numpy(nhwc_keep_to_nchw(masks[i])))
            tm = step(state, {k: torch.from_numpy(v) for k, v in lab[i].items()},
                      {k: torch.from_numpy(v) for k, v in unlab[i].items()}, draws)
            tl.append([float(tm[c]) for c in cols])
            assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)

            after = _flat(jstate.params, jstate.batch_stats)
            sd = state.model.state_dict()
            for k, v in after.items():
                got = sd[k].numpy()
                if "running_" in k:
                    # the model test's bound: f32 conv order, one-pass vs Welford variance
                    np.testing.assert_allclose(got, v, rtol=1e-3, atol=1e-3 * np.abs(v).max(),
                                               err_msg=k)
                    continue
                # The update (SGD with momentum, 10x decoder group, weight decay)
                # within 15% of the reference's, per tensor: measured 5.4% at
                # most, JAX's own spread under a 1e-7 weight perturbation 5.5%.
                # A wrong LR group, momentum order or loss term moves it by O(1).
                want = v - before[k]
                err = np.linalg.norm((got - before[k]) - want)
                assert err <= 0.15 * np.linalg.norm(want) + 1e-7 * np.linalg.norm(v), (i, k)
            # the teacher moves by (1 - alpha) of the student: the reference
            # suite's short-horizon bound on every tensor
            _close(_flat(jstate.ema_params, jstate.ema_batch_stats),
                   state.ema_model.state_dict(), 5e-3)
    jl, tl = np.array(jl), np.array(tl)
    assert np.all(jl[:, 2] > 0)  # the confidence mask let pixels through
    # the reference suite's per-step loss tolerance
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)
    assert state.step == STEPS


class _Toy(torch.nn.Module):
    """Parameters under ``encoder`` (backbone group) and ``decoder`` (10x
    group) plus a BN-style buffer, mirroring a reference tree."""

    def __init__(self, tree):
        super().__init__()
        for group, leaves in tree.items():
            mod = torch.nn.Module()
            for name, v in leaves.items():
                mod.register_parameter(name, torch.nn.Parameter(torch.from_numpy(v.copy())))
            setattr(self, group, mod)
        self.register_buffer("running_mean", torch.zeros(3))


def test_sgd_and_ema_match_the_reference_optax_chain():
    """Poly LR, weight decay, momentum order and the 10x decoder group, over
    4 steps of the same gradients: f32 on both sides, so to rounding."""
    from semi_supervised_semantic_segmentation_tpu.engine import state as jstate_mod
    from semi_supervised_semantic_segmentation_tpu_torch.engine import state as tstate_mod

    rng = np.random.RandomState(0)
    tree = {"encoder": {"w": rng.randn(4, 3).astype(np.float32)},
            "decoder": {"b": rng.randn(5).astype(np.float32)}}
    raw = {"data": {"dataset": "synthetic"}, "optim": {"lr": 0.05, "weight_decay": 1e-3}}
    total = 6
    tx = jstate_mod.make_optimizer(jconfig.config_from_dict(raw), total)
    jparams = jax.tree.map(jnp.asarray, tree)
    opt = tx.init(jparams)
    model = _Toy(tree)
    sgd = tstate_mod.SGD(config.config_from_dict(raw), model, total)
    for i in range(4):
        grads = jax.tree.map(lambda v: rng.randn(*v.shape).astype(np.float32), tree)
        upd, opt = tx.update(jax.tree.map(jnp.asarray, grads), opt, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        for name, p in model.named_parameters():
            group, leaf = name.split(".")
            p.grad = torch.from_numpy(grads[group][leaf])
        sgd.step(i)
        for name, p in model.named_parameters():
            group, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[group][leaf]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {i} {name}")

    teacher = _Toy(tree)
    teacher.running_mean.fill_(1.0)
    model.running_mean.copy_(torch.arange(3.0))
    tstate_mod.ema_update(teacher, model, 0.99)
    want = jstate_mod.ema_update(
        {**jax.tree.map(jnp.asarray, tree), "rm": jnp.ones(3)},
        {**jparams, "rm": jnp.arange(3.0)}, jnp.float32(0.99))
    np.testing.assert_allclose(teacher.running_mean.numpy(), np.asarray(want["rm"]), rtol=1e-6)
    for name, p in teacher.named_parameters():
        group, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[group][leaf]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
