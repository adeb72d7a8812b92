"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: capturing the reference's dropout masks and turning its CutMix box
masks into the port's (y1, y2, x1, x2) boxes."""

from __future__ import annotations

from typing import List

import flax.linen as fnn
import jax
import numpy as np


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
