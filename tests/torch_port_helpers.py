"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: capturing the reference's dropout masks, turning its CutMix box
masks into the port's (y1, y2, x1, x2) boxes, replaying a FixMatch step's
CutMix draw, and the port's identity-augmentation draws."""

from __future__ import annotations

from typing import List

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from semi_supervised_semantic_segmentation_tpu.ops import augment as jaug
from semi_supervised_semantic_segmentation_tpu_torch.methods import fixmatch
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment


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
    def weak(b):
        z = torch.zeros(b)
        return augment.WeakParams(scale=torch.ones(b), oy=z, ox=z.clone(),
                                  flip=torch.zeros(b, dtype=torch.bool))

    off = torch.zeros(nu, dtype=torch.bool)
    strong = augment.StrongParams(factors=torch.ones(nu, 4), perm=torch.arange(4).repeat(nu, 1),
                                  apply_jitter=off, apply_gray=off, sigma=torch.ones(nu),
                                  apply_blur=off)
    return fixmatch.Draws(weak_l=weak(nl), weak_u=weak(nu), strong=strong,
                          boxes=torch.from_numpy(boxes), dropout=dropout)
