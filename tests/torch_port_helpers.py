"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: capturing the reference's dropout masks, turning its CutMix box
masks into the port's (y1, y2, x1, x2) boxes, replaying a FixMatch step's
CutMix draw, the port's identity-augmentation draws, seeded uint8 batches,
and a method's steps run beside the reference's from re-synced weights."""

from __future__ import annotations

import contextlib
from typing import List

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.ops import augment as jaug
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.methods import fixmatch
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment


@contextlib.contextmanager
def one_torch_thread():
    """Run torch's CPU ops on one intra-op thread: the suite runs several
    pytest workers on the machine's cores, and each worker's torch would
    otherwise start a thread per core, which oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def capture_dropout_masks(store: List[np.ndarray]):
    """Context manager: every training-mode ``flax.linen.Dropout`` call made while it is
    active (including inside a jitted function traced under it) appends its
    keep-mask to ``store`` when it runs.  Where the input is exactly 0 the
    mask cannot be read from the output and is reported as keep (the output
    is 0 either way)."""

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not mod.deterministic and not kwargs.get("deterministic")):
            keep = (out != 0) | (args[0] == 0)
            jax.debug.callback(lambda k: store.append(np.asarray(k)), keep)
        return out

    return fnn.intercept_methods(interceptor)


def boxes_from_masks(mask: np.ndarray) -> np.ndarray:
    """(B,H,W) bool rectangles -> int32 (B,4) (y1, y2, x1, x2); empty -> 0s."""
    out = np.zeros((mask.shape[0], 4), np.int32)
    for i, m in enumerate(mask):
        ys, xs = np.where(m)
        if len(ys):
            assert len(ys) == (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1)
            out[i] = (ys.min(), ys.max() + 1, xs.min(), xs.max() + 1)
    return out


def nhwc_keep_to_nchw(keep: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(keep, (0, 3, 1, 2)))


def replay_cutmix_boxes(rng_data, step: int, nu: int, crop: int) -> np.ndarray:
    """The JAX FixMatch step's CutMix draw (cutmix_prob 1):
    fold_in(key, step) -> split(5)[3] -> (box, apply) keys."""
    key = jax.random.fold_in(jax.random.wrap_key_data(jnp.asarray(rng_data)), step)
    kmix = jax.random.split(key, 5)[3]
    kbox, kapply = jax.random.split(kmix)
    box = jaug.cutmix_boxes(kbox, nu, crop, crop)
    apply = jax.random.uniform(kapply, (nu,)) < 1.0
    return boxes_from_masks(np.asarray(box & apply[:, None, None]))


def identity_draws(nl: int, nu: int, boxes: np.ndarray, dropout) -> fixmatch.Draws:
    """Port draws with identity weak/strong augmentation, the given CutMix
    boxes and dropout (a keep-mask, or None for a model without dropout)."""
    return fixmatch.Draws(weak_l=identity_weak(nl), weak_u=identity_weak(nu),
                          strong=identity_strong(nu), boxes=torch.from_numpy(boxes),
                          dropout=dropout)


def identity_weak(b: int) -> augment.WeakParams:
    z = torch.zeros(b)
    return augment.WeakParams(scale=torch.ones(b), oy=z, ox=z.clone(),
                              flip=torch.zeros(b, dtype=torch.bool))


def identity_strong(b: int) -> augment.StrongParams:
    off = torch.zeros(b, dtype=torch.bool)
    return augment.StrongParams(factors=torch.ones(b, 4), perm=torch.arange(4).repeat(b, 1),
                                apply_jitter=off, apply_gray=off, sigma=torch.ones(b),
                                apply_blur=off)


def uint8_batches(steps: int, batch: int, crop: int, ncls: int, seed: int, labeled: bool):
    """``steps`` host batches of random uint8 images at ``crop`` (labels
    with 10 % ignored pixels, or all-ignore for an unlabeled batch)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        image = (rng.rand(batch, crop, crop, 3) * 255).astype(np.uint8)
        if labeled:
            label = rng.randint(0, ncls, (batch, crop, crop)).astype(np.int32)
            label[rng.rand(batch, crop, crop) < 0.1] = 255
        else:
            label = np.full((batch, crop, crop), 255, np.int32)
        out.append({"image": image, "label": label,
                    "size": np.full((batch, 2), crop, np.int32)})
    return out


def flat_state(params, stats):
    return jcompat.flatten_params_to_torch_layout(jax.device_get(params), jax.device_get(stats))


def steps_against_jax(jcfg, jmodel, jmethod, cfg, method, steps: int, lab, unlab, draws,
                      cols, teacher_bound=None):
    """Run ``steps`` steps of the JAX method and of the port's from the same
    batches, re-synchronising the port's weights, BN statistics and teacher
    to the reference's before each step (the port's momentum carries over),
    and hold each step's update against the reference's: running
    statistics under the model test's bound (rtol 1e-3, atol 1e-3 max|v|),
    every other tensor's update within 15 % of the reference's (relative
    norm), the teacher within ``teacher_bound`` per tensor, the lr within
    1e-6.  ``draws(i)`` gives the port's draws of step i; ``unlab`` is None
    for a method without unlabeled data.  Returns the (reference, port)
    metrics ``cols`` of every step as two arrays."""
    jstate = jmethod.init_state(jcfg, jmodel, jax.random.key(0), steps)
    jstep = jax.jit(jmethod.make_train_step(jcfg, jmodel, steps))
    state = method.init_state(cfg, build_model(cfg), steps)
    step = method.make_train_step(cfg, steps)
    jl, tl = [], []
    for i in range(steps):
        compat.load_flax_variables(state.model, jax.device_get(jstate.params),
                                   jax.device_get(jstate.batch_stats))
        if teacher_bound is not None:
            compat.load_flax_variables(state.ema_model, jax.device_get(jstate.ema_params),
                                       jax.device_get(jstate.ema_batch_stats))
        before = flat_state(jstate.params, {})
        jargs = [{k: jnp.asarray(v) for k, v in b[i].items()}
                 for b in (lab, unlab) if b is not None]
        jstate, jm = jstep(jstate, *jargs)
        jl.append([float(jm[c]) for c in cols])
        targs = [{k: torch.from_numpy(v) for k, v in b[i].items()} if b is not None else None
                 for b in (lab, unlab)]
        tm = step(state, *targs, draws(i))
        tl.append([float(tm[c]) for c in cols])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * abs(float(jm["lr"]))

        sd = state.model.state_dict()
        for k, v in flat_state(jstate.params, jstate.batch_stats).items():
            got = sd[k].numpy()
            if "running_" in k:
                np.testing.assert_allclose(got, v, rtol=1e-3, atol=1e-3 * np.abs(v).max(),
                                           err_msg=k)
                continue
            want = v - before[k]
            err = np.linalg.norm((got - before[k]) - want)
            assert err <= 0.15 * np.linalg.norm(want) + 1e-7 * np.linalg.norm(v), (i, k)
        if teacher_bound is not None:
            # per tensor, max|a-b| / max(max|a|, 0.1)
            tsd = state.ema_model.state_dict()
            for k, v in flat_state(jstate.ema_params, jstate.ema_batch_stats).items():
                rel = np.max(np.abs(v - tsd[k].numpy())) / max(np.max(np.abs(v)), 0.1)
                assert rel < teacher_bound, (i, k, rel)
    assert state.step == steps
    return np.array(jl), np.array(tl)

