"""HRNet-W48 encoder and the HRNetV2 segmentation head (counterpart of the
reference's ``models/hrnet.py``).

  stem: two 3x3 stride-2 Conv-BN-ReLU (-> stride 4, 64 ch)
  layer1: 4 Bottlenecks(64) -> 256 ch at s4
  transition1 -> branches [w, 2w]; stage2: 1 module
  transition2 -> + branch 4w;      stage3: 4 modules
  transition3 -> + branch 8w;      stage4: 3 modules
(module counts are ``stage_modules``), each module = 4 BasicBlocks per
branch + cross-resolution fusion (1x1 Conv-BN + bilinear up for a lower
resolution, chained 3x3 stride-2 Conv-BNs for a higher one, summed, ReLU).
Taps c1 (stem1 output, s2), c2..c5 (the branches, s4..s32), NCHW.

Under a model axis (``parallel.model_parallel > 1``; ``layers.use_mesh``
sets ``spatial`` on :meth:`HRNet.spatial_blocks`) the forward cuts the
input to this model rank's H rows, runs both stem convs H-sharded and
gathers the stem's output over the model axis before ``layer1``: the rest
of the net runs on whole rows, the same on every model rank (the
reference's ``hrnet.py:258-278``), in every mode.  The taps then leave c1
out: no decoder HRNet takes reads it (U-Net refuses HRNet), and a gather
of it would move the largest activation for nothing.

``branch_conv='pallas'`` runs every eligible branch (C <= 128, H % 32 == 0:
the 48/96-ch branches of W48) through the fused flow of
:class:`~.resnet.BasicBlock` (kernels D and E on the card); the others stay
on cuDNN.  The activations are NCHW throughout, so the reference's
transposes around eligible branches have no counterpart.  The reference's
``fuse_impl``/``stem_impl: s2d`` are TPU formulations of the same convs and
map to the plain conv here.

``remat_stages`` checkpoints stages (1 = layer1) as the reference's
``nn.remat``: ``remat_scope='module'`` whole HR modules,
``'branch_blocks'`` only their branch BasicBlocks.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.models.layers import (
    Conv2d,
    ConvNormAct,
    Norm,
    checkpoint,
)
from semi_supervised_semantic_segmentation_tpu_torch.models.resnet import BasicBlock, Bottleneck
from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv as bconv
from semi_supervised_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear
from semi_supervised_semantic_segmentation_tpu_torch.parallel import spatial


def _remat_active(module: nn.Module) -> bool:
    return module.training and torch.is_grad_enabled()


class HRModule(nn.Module):
    def __init__(self, channels: Sequence[int], num_blocks: int = 4, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, branch_conv: str = "xla",
                 remat_blocks: bool = False):
        super().__init__()
        self.channels = tuple(channels)
        self.num_blocks = num_blocks
        self.branch_conv = branch_conv
        self.remat_blocks = remat_blocks
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype)
        n = len(self.channels)
        for i, c in enumerate(self.channels):
            for b in range(num_blocks):
                setattr(self, f"branch{i}_block{b}", BasicBlock(c, c, **kw))
        for i in range(n):
            for j in range(n):
                if j > i:
                    setattr(self, f"fuse_up_{j}_to_{i}",
                            ConvNormAct(self.channels[j], self.channels[i], 1, act=False, **kw))
                for k in range(i - j):
                    last = k == i - j - 1
                    setattr(self, f"fuse_down_{j}_to_{i}_{k}", ConvNormAct(
                        self.channels[j], self.channels[i] if last else self.channels[j], 3,
                        stride=2, act=not last, **kw))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n = len(self.channels)
        remat = self.remat_blocks and _remat_active(self)
        ys = []
        for i, c in enumerate(self.channels):
            x = xs[i]
            fused = self.branch_conv == "pallas" and bconv.supported(x.shape, x.shape[1], c)
            for b in range(self.num_blocks):
                block = getattr(self, f"branch{i}_block{b}")
                x = checkpoint(block, x, fused) if remat else block(x, fused)
            ys.append(x)

        outs = []
        for i in range(n):
            acc = ys[i]
            for j in range(n):
                if j > i:
                    t = getattr(self, f"fuse_up_{j}_to_{i}")(ys[j])
                    t = resize_bilinear(t, ys[i].shape[-2:], align_corners=False).to(acc.dtype)
                elif j < i:
                    t = ys[j]
                    for k in range(i - j):
                        t = getattr(self, f"fuse_down_{j}_to_{i}_{k}")(t)
                else:
                    continue
                acc = acc + t
            outs.append(F.relu(acc))
        return outs


class HRNetV2Head(nn.Module):
    """The HRNetV2 head: every branch to the stride-4 resolution, a 1x1
    Conv-BN-ReLU at the concat width (kept as one 1x1 conv per branch,
    ``fuse0..3``, summed: the same map as one conv over the concat), a 1x1
    conv to the classes, bilinear to the input size.  ``fuse_order``
    'conv_first' convolves each branch at its own resolution and upsamples
    the result; 'up_first' upsamples the branch and convolves at the base
    resolution.  Same parameters and math either way."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, fuse_order: str = "conv_first"):
        super().__init__()
        if fuse_order not in ("conv_first", "up_first"):
            raise ValueError(f"unknown head fuse order {fuse_order!r}")
        width = sum(in_channels)
        self.fuse0 = Conv2d(in_channels[0], width, 1, bias=True, compute_dtype=compute_dtype)
        for i, c in enumerate(in_channels[1:]):
            setattr(self, f"fuse{i + 1}", Conv2d(c, width, 1, compute_dtype=compute_dtype))
        self.fuse_norm = Norm(width, bn_momentum)
        self.head = Conv2d(width, num_classes, 1, bias=True, compute_dtype=compute_dtype)
        self.fuse_order = fuse_order
        self.compute_dtype = compute_dtype

    def forward(self, taps: Dict[str, torch.Tensor], out_hw: Tuple[int, int],
                rng=None) -> torch.Tensor:
        base = taps["c2"]
        hw = base.shape[-2:]
        acc = self.fuse0(base)
        for i, k in enumerate(("c3", "c4", "c5")):
            conv = getattr(self, f"fuse{i + 1}")
            if self.fuse_order == "up_first":
                acc = acc + conv(resize_bilinear(taps[k], hw).to(self.compute_dtype))
            else:
                acc = acc + resize_bilinear(conv(taps[k]), hw).to(acc.dtype)
        x = F.relu(self.fuse_norm(acc))
        return resize_bilinear(self.head(x), out_hw, align_corners=False)


class HRNet(nn.Module):
    def __init__(self, width: int = 48, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 stage_modules: Tuple[int, int, int] = (1, 4, 3),
                 remat_stages: Tuple[int, ...] = (), remat_scope: str = "module",
                 branch_conv: str = "xla", branch_widths: Tuple[int, ...] = ()):
        super().__init__()
        if remat_scope not in ("module", "branch_blocks"):
            raise ValueError(f"unknown remat scope {remat_scope!r}")
        self.width = width
        self.stage_modules = tuple(stage_modules)
        self.branch_widths = tuple(branch_widths) or (width, 2 * width, 4 * width, 8 * width)
        self.remat_stages = tuple(remat_stages)
        self.remat_scope = remat_scope
        widths = self.branch_widths
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype)
        self.stem1 = ConvNormAct(3, 64, 3, stride=2, **kw)
        self.stem2 = ConvNormAct(64, 64, 3, stride=2, **kw)
        for b in range(4):
            setattr(self, f"layer1_{b}", Bottleneck(64 if b == 0 else 256, 64,
                                                    downsample=(b == 0), **kw))
        self.transition1_0 = ConvNormAct(256, widths[0], 3, **kw)
        self.transition1_1 = ConvNormAct(256, widths[1], 3, stride=2, **kw)
        self.transition2_2 = ConvNormAct(widths[1], widths[2], 3, stride=2, **kw)
        self.transition3_3 = ConvNormAct(widths[2], widths[3], 3, stride=2, **kw)
        blocks = remat_scope == "branch_blocks"
        for stage, count in zip((2, 3, 4), self.stage_modules):
            for m in range(count):
                setattr(self, f"stage{stage}_m{m}", HRModule(
                    widths[:stage], branch_conv=branch_conv,
                    remat_blocks=blocks and stage in self.remat_stages, **kw))

    def _stage(self, stage: int, module: nn.Module, x):
        """Run ``module``, checkpointed when the plan says so ('module'
        scope; the 'branch_blocks' scope checkpoints inside HRModule)."""
        if stage not in self.remat_stages or not _remat_active(self) or (
                stage > 1 and self.remat_scope == "branch_blocks"):
            return module(x)
        if isinstance(x, list):
            return checkpoint(lambda *xs: module(list(xs)), *x)
        return checkpoint(module, x)

    def spatial_blocks(self) -> Tuple[ConvNormAct, ConvNormAct]:
        """The blocks that run H-sharded under a model axis."""
        return self.stem1, self.stem2

    def forward(self, x_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        mesh = self.stem1.spatial
        x = x_nhwc.permute(0, 3, 1, 2)
        if mesh is not None:
            x = spatial.shard_h(x, mesh)
        x = self.stem1(x)
        taps = {} if mesh is not None else {"c1": x}  # stride 2
        x = self.stem2(x)
        if mesh is not None:
            x = spatial.gather_h(x, mesh)
        for b in range(4):
            x = self._stage(1, getattr(self, f"layer1_{b}"), x)
        xs = [self.transition1_0(x), self.transition1_1(x)]
        for stage, count in zip((2, 3, 4), self.stage_modules):
            if stage == 3:
                xs.append(self.transition2_2(xs[-1]))
            elif stage == 4:
                xs.append(self.transition3_3(xs[-1]))
            for m in range(count):
                xs = self._stage(stage, getattr(self, f"stage{stage}_m{m}"), xs)
        return {**taps, "c2": xs[0], "c3": xs[1], "c4": xs[2], "c5": xs[3]}
