"""Plain PyTorch layers of the reference models, in float32.

The reference imports nothing of the measured program.  It holds the same
parameter names as the program's models (``Conv_0``, ``Norm_0.BatchNorm_0``),
so one state dict made by the benchmark loads into both.

``Rounding`` is what a layer does to the tensors it holds: ``exact`` for
the float32 reference; ``bf16`` for the reference at the configurations'
own precision, which holds every activation (conv operands and outputs,
BatchNorm outputs, block outputs, resized maps, logits) and its gradient
in bfloat16, as plain autocast would; and ``fp8`` for the control, which
holds them in float8 e4m3 with one scale per tensor, and their gradients
in e5m2: the precision below the bfloat16 in which the configurations hold
them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

Rounding = Callable[[torch.Tensor], torch.Tensor]


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def _fake_quant(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / t.detach().abs().amax().float().clamp_min(1e-30)
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fake_quant(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fake_quant(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return _Bf16.apply(t)


ROUNDINGS = {"f32": exact, "bf16": bf16, "fp8": fp8}


class Recompute:
    """Marks a checkpointed forward while the backward re-runs it, so that
    BatchNorm does not update its running statistics twice."""

    def __init__(self):
        self.on = False

    @contextlib.contextmanager
    def scope(self):
        prev, self.on = self.on, True
        try:
            yield
        finally:
            self.on = prev


def checkpoint(recompute: Recompute, fn, *args):
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute.scope()))


def conv(x, w, rounding: Rounding, bias=None, stride=1, padding=0, dilation=1):
    return rounding(F.conv2d(rounding(x), rounding(w), bias, stride, padding, dilation))


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear, align_corners=False; the identity at the same size."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


class Conv2d(nn.Conv2d):
    def __init__(self, cin, cout, k, stride=1, dilation=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) * dilation // 2,
                         dilation=dilation, bias=bias)
        self.rounding: Rounding = exact

    def forward(self, x):
        return conv(x, self.weight, self.rounding, self.bias, self.stride, self.padding,
                    self.dilation)


class BatchNorm(nn.Module):
    """Batch statistics in training (biased variance to normalize, unbiased
    for the running variance), running statistics in eval; the running
    statistics move by 0.1 of the batch's (momentum 0.9 in the flax
    convention), eps 1e-5."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.recompute: Optional[Recompute] = None
        self.rounding: Rounding = exact
        self.momentum = 0.1

    def forward(self, x):
        rm, rv = self.running_mean, self.running_var
        if self.training and self.recompute is not None and self.recompute.on:
            rm, rv = rm.clone(), rv.clone()
        return self.rounding(F.batch_norm(x, rm, rv, self.weight, self.bias, self.training,
                                          self.momentum, 1e-5))


class Norm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return self.BatchNorm_0(x)


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, k, stride=1, dilation=1, act=True):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cout, k, stride, dilation)
        self.Norm_0 = Norm(cout)
        self.act = act

    def forward(self, x):
        x = self.Norm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


def configure(model: nn.Module, rounding: Rounding, recompute: Recompute) -> None:
    """Give every module of ``model`` that rounds what it computes (convs,
    BatchNorms, blocks, the decoder) its rounding, and every BatchNorm the
    model's recompute marker."""
    for m in model.modules():
        if hasattr(m, "rounding"):
            m.rounding = rounding
        if isinstance(m, BatchNorm):
            m.recompute = recompute
