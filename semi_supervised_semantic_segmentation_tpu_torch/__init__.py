"""PyTorch/CUDA port of the semi-supervised segmentation framework.

The JAX package ``semi_supervised_semantic_segmentation_tpu`` is the
reference; this package mirrors its module names (config, data, ops,
models, methods, engine) and imports none of it.  Every Pallas kernel on a
ported path has a hand-written Hopper counterpart (CUDA C++ under
``csrc/`` or Triton) beside a plain PyTorch version of the same function.

Entry points run on CUDA unless the caller asks for the CPU explicitly
(``device="cpu"``); see :func:`resolve_device`.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``, which must exist; any explicit device is taken
    as given.  There is no quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to "
            "run on the CPU explicitly"
        )
    return dev
