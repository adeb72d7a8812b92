"""Bilinear resize with ``F.interpolate`` semantics (NCHW).

Counterpart of the reference's ``ops/resize.py::resize_bilinear``, which
rebuilds exactly these semantics from two interpolation matrices:
``align_corners=True``: src = dst*(in-1)/(out-1); ``False``:
src = (dst+0.5)*in/out - 0.5, edge-clamped.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize the two trailing spatial axes of an (N, C, H, W) tensor."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)
