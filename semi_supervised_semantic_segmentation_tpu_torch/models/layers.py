"""Shared model blocks (NCHW activations in the compute dtype, f32 params).

Counterpart of the reference's ``models/layers.py``.  Module attribute names
follow the reference's parameter paths (``Conv_0``, ``Norm_0.BatchNorm_0``)
so that ``state_dict()`` keys are exactly the keys of
``engine.compat.flatten_params_to_torch_layout`` -- the reference checkpoint
layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.ops.stem import stem_conv_bn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``: input, weight and
    bias are cast per call (the f32 params receive f32 gradients), as the
    reference's ``nn.Conv(dtype=..., param_dtype=float32)``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
                 bias: bool = False, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) * dilation // 2,
                         dilation=dilation, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        b = self.bias.to(d) if self.bias is not None else None
        return F.conv2d(x.to(d), self.weight.to(d), b, self.stride, self.padding, self.dilation)


class BatchNorm(nn.Module):
    """BatchNorm with the reference ``TorchBatchNorm``'s semantics: batch
    statistics in f32, biased variance to normalize, unbiased to update the
    running variance, momentum 0.9 in the flax convention (0.1 in torch's),
    eps 1e-5.

    Normal mode is ``F.batch_norm`` (cuDNN on the card).  Folded mode
    (:meth:`fold`) takes the per-channel (sum, sum of squares) [2, C] of
    ``count`` elements -- the stem kernel's own statistics -- updates the
    running stats identically and returns the f32 (mul, add) pair for the
    caller to apply; it is differentiable in the sums, so their cotangent
    reaches the kernel's backward."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, 1.0 - self.momentum, self.eps)

    def fold(self, sums: torch.Tensor, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (count / max(count - 1, 1))
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        return mul, self.bias - mean * mul


class Norm(nn.Module):
    """Holder that pins the reference's ``Norm_0.BatchNorm_0`` path."""

    def __init__(self, features: int, momentum: float = 0.9):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features, momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x)


class ConvNormAct(nn.Module):
    """Conv -> BatchNorm -> (optional) ReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
                 act: bool = True, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cout, k, stride, dilation, compute_dtype=compute_dtype)
        self.Norm_0 = Norm(cout, bn_momentum)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Norm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


class StemSegment(nn.Module):
    """7x7/s2 stem conv + BatchNorm + ReLU + 3x3/s2 max-pool on an NHWC
    image, returning NCHW (pooled, c1).

    ``impl='pallas'`` is the counterpart of the reference's
    ``PallasStemSegment``: the conv runs through ``ops.stem.stem_conv_bn``
    (kernels B and C on the card), the BatchNorm is folded from the
    kernel's own statistics (so the statistics' cotangent reaches kernel
    C), then ReLU and the max-pool with -inf padding.  Any other impl runs
    the plain conv + BatchNorm on the same parameters.  Same math either
    way."""

    def __init__(self, features: int = 64, kernel: int = 7, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, impl: str = "conv"):
        super().__init__()
        self.Conv_0 = Conv2d(3, features, kernel, stride=2, compute_dtype=compute_dtype)
        self.Norm_0 = Norm(features, bn_momentum)
        self.impl = impl

    def forward(self, x_nhwc: torch.Tensor):
        dtype = self.Conv_0.compute_dtype
        if self.impl == "pallas":
            y, sums = stem_conv_bn(x_nhwc.to(dtype), self.Conv_0.weight)
            n, _, h2, w2 = y.shape
            mul, add = self.Norm_0.BatchNorm_0.fold(sums, n * h2 * w2)
            # the reference's fma: mul and add rounded to the compute dtype,
            # the product and sum in f32, one rounding
            mul = mul.to(dtype).float()[None, :, None, None]
            add = add.to(dtype).float()[None, :, None, None]
            y = (y.float() * mul + add).to(dtype)
        else:
            y = self.Norm_0(self.Conv_0(x_nhwc.permute(0, 3, 1, 2)))
        c1 = F.relu(y)
        return F.max_pool2d(c1, 3, 2, 1), c1


def dropout(x: torch.Tensor, p: float, training: bool,
            rng: Optional[object] = None) -> torch.Tensor:
    """Dropout that keeps each element with probability 1-p and scales by
    1/(1-p).  ``rng`` is a ``torch.Generator`` to draw the mask from, a
    precomputed bool keep-mask of x's shape, or None (global RNG)."""
    if not training or p <= 0.0:
        return x
    if rng is None:
        return F.dropout(x, p, True)
    if isinstance(rng, torch.Generator):
        keep = torch.rand(x.shape, generator=rng, device=x.device) < (1.0 - p)
    else:
        keep = rng.to(device=x.device, dtype=torch.bool)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
