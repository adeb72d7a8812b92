"""Shared model blocks (NCHW activations in the compute dtype, f32 params).

Counterpart of the reference's ``models/layers.py``.  Module attribute names
follow the reference's parameter paths (``Conv_0``, ``Norm_0.BatchNorm_0``)
so that ``state_dict()`` keys are exactly the keys of
``engine.compat.flatten_params_to_torch_layout`` -- the reference checkpoint
layout.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv
from semi_supervised_semantic_segmentation_tpu_torch.ops.stem import stem_conv_bn
from semi_supervised_semantic_segmentation_tpu_torch.parallel import spatial
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, size

_RECOMPUTE = threading.local()
_VMAP = threading.local()


def recomputing() -> bool:
    """True while :func:`checkpoint` re-runs a forward for the backward."""
    return getattr(_RECOMPUTE, "on", False)


@contextlib.contextmanager
def _recompute_scope():
    prev, _RECOMPUTE.on = recomputing(), True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


@contextlib.contextmanager
def vmapped():
    """Marks a forward run under ``torch.func.vmap`` over stacked nets
    (CPS's ``stacked`` form): :class:`BatchNorm` then normalizes in f32,
    and no remat plan checkpoints (:func:`remat_active`)."""
    prev, _VMAP.on = getattr(_VMAP, "on", False), True
    try:
        yield
    finally:
        _VMAP.on = prev


def remat_active(module: nn.Module) -> bool:
    """Whether a remat plan checkpoints ``module``'s blocks now: in training
    with autograd on, and not under :func:`vmapped`.  ``torch.func.vmap``
    cannot carry ``torch.utils.checkpoint`` (the backward's re-run meets
    tensors from inside the vmapped function), so CPS's ``stacked`` form
    keeps every activation, as with no plan; the values are the same."""
    return module.training and torch.is_grad_enabled() and not getattr(_VMAP, "on", False)


def checkpoint(fn, *args):
    """Activation checkpointing (the reference's ``nn.remat``): ``fn``'s
    activations are not kept; the backward re-runs its forward.  Unlike
    flax's remat, torch re-runs the module code, so the re-run is marked
    (:func:`recomputing`) and BatchNorm does not update its running
    statistics a second time.  ``fn`` draws no random numbers."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute_scope()))


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
    ``count`` elements -- a kernel's own statistics -- updates the running
    stats identically and returns the f32 (mul, add) pair for the caller to
    apply; it is differentiable in the sums, so their cotangent reaches the
    kernel's backward.  Neither mode updates the running statistics while a
    checkpointed forward is re-run (:func:`recomputing`).  Under
    :func:`vmapped` a bf16 input is normalized in f32 and rounded once.

    With a ``mesh`` of R > 1 ranks (:func:`use_mesh`) training mode is
    SyncBN, the reference's one-pass statistics over the global batch: the
    per-channel (sum, sum of squares) of this rank's rows in f32 (or x's
    wider dtype), summed over ranks (``all_reduce_sum``, whose backward sums
    the cotangent over ranks too), folded with the global count, and
    applied as ``x * mul + add`` in that dtype, rounded once.  With R = 1 it stays ``F.batch_norm``."""

    mesh: Optional[Mesh] = None

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rm, rv = self.running_mean, self.running_var
        if self.training and recomputing():
            # a re-run updates copies (the same ops save the same tensors)
            rm, rv = rm.clone(), rv.clone()
        if self.training and self.mesh is not None and self.mesh.size > 1:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            sums = all_reduce_sum(torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]),
                                  self.mesh)
            mul, add = self.fold(sums, x.numel() // x.shape[1] * self.mesh.size)
            return (xf * mul[None, :, None, None] + add[None, :, None, None]).to(x.dtype)
        if getattr(_VMAP, "on", False) and x.dtype != self.weight.dtype:
            # vmap's batch_norm rule on the CPU refuses a bf16 input with
            # f32 parameters: normalize in f32 and round the output once
            return F.batch_norm(x.float(), rm, rv, self.weight, self.bias, self.training,
                                1.0 - self.momentum, self.eps).to(x.dtype)
        return F.batch_norm(x, rm, rv, self.weight, self.bias, self.training,
                            1.0 - self.momentum, self.eps)

    def fold(self, sums: torch.Tensor, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
            if not recomputing():
                self._update_running(mean.detach(), var.detach(), count)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        return mul, self.bias - mean * mul

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor, count: int) -> None:
        m = self.momentum
        unbiased = var * (count / max(count - 1, 1))
        self.running_mean.mul_(m).add_((1.0 - m) * mean)
        self.running_var.mul_(m).add_((1.0 - m) * unbiased)


class GroupNorm(nn.Module):
    """The reference's ``nn.GroupNorm(num_groups=min(32, C), dtype=compute,
    param_dtype=float32)`` of flax 0.12, on NCHW, as plain tensor ops: per
    sample and group of C/G contiguous channels, mean and mean square over
    (C/G, H, W) in f32, variance E[x^2] - E[x]^2 clipped at 0, then
    ``(x - mean) * (rsqrt(var + 1e-6) * weight) + bias`` in f32, rounded once
    to x's dtype.  f32 parameters, no buffers.  A channel count the group
    count does not divide raises, with flax's message."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.groups = min(32, features)
        if features % self.groups:
            raise ValueError(f"model.norm='groupnorm': Number of groups ({self.groups}) does "
                             f"not divide the number of channels ({features}).")
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        grouped = xf.reshape(n, self.groups, -1)
        mean = grouped.mean(-1)
        var = torch.clamp((grouped * grouped).mean(-1) - mean * mean, min=0.0)
        mean, var = (t.repeat_interleave(c // self.groups, 1)[:, :, None, None]
                     for t in (mean, var))
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return ((xf - mean) * mul + self.bias[:, None, None]).to(x.dtype)


class Norm(nn.Module):
    """Holder that pins the reference's ``Norm_0.BatchNorm_0`` or
    ``Norm_0.GroupNorm_0`` path (``kind``)."""

    def __init__(self, features: int, momentum: float = 0.9, kind: str = "batchnorm"):
        super().__init__()
        if kind == "batchnorm":
            self.BatchNorm_0 = BatchNorm(features, momentum)
        elif kind == "groupnorm":
            self.GroupNorm_0 = GroupNorm(features)
        else:
            raise ValueError(f"unknown norm kind: {kind!r}")
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x) if self.kind == "batchnorm" else self.GroupNorm_0(x)


class ConvNormAct(nn.Module):
    """Conv -> Norm (BatchNorm, or GroupNorm: ``norm``) -> (optional) ReLU.

    With ``spatial`` (a mesh with a model axis, set by :func:`use_mesh`) the
    block is the reference's ``SpatialConv`` path: x is this model rank's H
    rows, the stride-2 3x3 conv runs through
    ``parallel.spatial.spatial_conv2d_stride2`` (one halo row from the
    previous rank) on the same parameters, and the output stays H-sharded."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
                 act: bool = True, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, norm: str = "batchnorm"):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cout, k, stride, dilation, compute_dtype=compute_dtype)
        self.Norm_0 = Norm(cout, bn_momentum, norm)
        self.act = act

    mesh: Optional[Mesh] = None
    spatial: Optional[Mesh] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.Conv_0
        if self.spatial is not None:
            d = conv.compute_dtype
            y = spatial.spatial_conv2d_stride2(x.to(d), conv.weight.to(d), self.spatial)
        else:
            y = conv(x)
        x = self.Norm_0(y)
        return F.relu(x) if self.act else x

    def raw(self, x: torch.Tensor, fold: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """The fused branch-chain flow (the reference's NCHW
        ``ConvNormAct(raw_out=True)`` over ``PallasConvBN``): a stride-1 3x3
        conv through ``ops.branch_conv`` (kernels D and E on the card) that
        applies the previous layer's folded BatchNorm + ReLU ``fold`` to its
        input inside the kernel, and returns the conv output before its own
        BatchNorm with that BatchNorm's folded f32 (mul, add), computed from
        the kernel's statistics.  The caller applies the pair (or hands it
        to the next conv) and the activation."""
        conv = self.Conv_0
        x = x.to(conv.compute_dtype)
        if not (conv.kernel_size == (3, 3) and conv.stride == (1, 1) and conv.dilation == (1, 1)
                and branch_conv.supported(x.shape, x.shape[1], conv.out_channels)):
            raise ValueError(f"fused branch conv needs a stride-1 3x3 conv with C_in == C_out "
                             f"<= 128 and H % 32 == 0, got {tuple(x.shape)} -> {conv.out_channels}")
        mesh = _train_mesh(self)
        y, sums = branch_conv.conv3x3_bn_nchw(x, conv.weight, *(fold or (None, None)), mesh=mesh)
        n, _, h, w = y.shape
        return y, self.Norm_0.BatchNorm_0.fold(sums, n * h * w * size(mesh))


class StemSegment(nn.Module):
    """7x7/s2 stem conv + BatchNorm + ReLU + 3x3/s2 max-pool on an NHWC
    image, returning NCHW (pooled, c1).

    ``impl='pallas'`` is the counterpart of the reference's
    ``PallasStemSegment``: the conv runs through ``ops.stem.stem_conv_bn``
    (kernels B and C on the card), the BatchNorm is folded from the
    kernel's own statistics (so the statistics' cotangent reaches kernel
    C), then ReLU and the max-pool with -inf padding.  Any other impl, and
    GroupNorm under any impl (no batch statistics to fold: the reference's
    ``PallasStemSegment`` takes its plain path then too), runs the plain
    conv + Norm on the same parameters.  Same math either way.  With a
    data ``mesh`` (:func:`use_mesh`) the kernel's statistics are summed
    over ranks in training (``stem_conv_bn``'s mesh form)."""

    mesh: Optional[Mesh] = None

    def __init__(self, features: int = 64, kernel: int = 7, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, impl: str = "conv",
                 norm: str = "batchnorm"):
        super().__init__()
        self.Conv_0 = Conv2d(3, features, kernel, stride=2, compute_dtype=compute_dtype)
        self.Norm_0 = Norm(features, bn_momentum, norm)
        self.impl = impl if norm == "batchnorm" else "conv"

    def forward(self, x_nhwc: torch.Tensor):
        dtype = self.Conv_0.compute_dtype
        if self.impl == "pallas":
            mesh = _train_mesh(self)
            y, sums = stem_conv_bn(x_nhwc.to(dtype), self.Conv_0.weight, mesh)
            n, _, h2, w2 = y.shape
            mul, add = self.Norm_0.BatchNorm_0.fold(sums, n * h2 * w2 * size(mesh))
            # the reference's fma: mul and add rounded to the compute dtype,
            # the product and sum in f32, one rounding
            mul = mul.to(dtype).float()[None, :, None, None]
            add = add.to(dtype).float()[None, :, None, None]
            y = (y.float() * mul + add).to(dtype)
        else:
            y = self.Norm_0(self.Conv_0(x_nhwc.permute(0, 3, 1, 2)))
        c1 = F.relu(y)
        return F.max_pool2d(c1, 3, 2, 1), c1


def _train_mesh(module: nn.Module) -> Optional[Mesh]:
    """The module's data mesh in training; None in eval, where the batch
    statistics go unused."""
    return module.mesh if module.training else None


def use_mesh(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Put every BatchNorm, stem segment and branch conv of ``model`` on the
    data axis of ``mesh`` (None: one process).

    Under a model axis (``mesh.model_size > 1``) the blocks that ``model``'s
    modules name in ``spatial_blocks()`` (HRNet's two stem convs) run
    H-sharded over it (``ConvNormAct.spatial``): their BatchNorms normalize
    the H-sharded outputs with statistics summed over every rank, data and
    model (``mesh.world``), and their parameters are marked
    ``model_partial``: each rank's gradient holds its rows' share, which
    ``parallel.mesh.all_reduce_grads`` sums over the model axis too.  A
    model with no such block raises: nothing runs unsharded instead."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, StemSegment, ConvNormAct)):
            m.mesh = mesh
    if mesh is None or mesh.model_size == 1:
        return
    blocks = [b for m in model.modules() if hasattr(m, "spatial_blocks")
              for b in m.spatial_blocks()]
    if not blocks:
        raise ValueError(f"a model axis of {mesh.model_size} ranks H-shards HRNet's stem; "
                         f"{type(model).__name__} has no block to shard")
    for b in blocks:
        conv = b.Conv_0
        if not (conv.kernel_size == (3, 3) and conv.stride == (2, 2)
                and conv.dilation == (1, 1) and conv.bias is None):
            raise ValueError(f"spatial sharding covers 3x3 stride-2 convs, got {conv}")
        b.spatial = mesh
        b.Norm_0.BatchNorm_0.mesh = mesh.world
        for p in b.parameters():
            p.model_partial = True


def keep_mask(shape, p: float, g: torch.Generator, device=None) -> torch.Tensor:
    """A dropout keep-mask of ``shape``: each element True with probability
    1-p, drawn from ``g``."""
    return torch.rand(shape, generator=g, device=device or g.device) < (1.0 - p)


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
        keep = keep_mask(x.shape, p, rng, x.device)
    else:
        keep = rng.to(device=x.device, dtype=torch.bool)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
