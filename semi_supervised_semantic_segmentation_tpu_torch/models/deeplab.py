"""DeepLabV3+ decoder with ASPP (counterpart of the reference's
``models/deeplab.py``).

ASPP = 1x1 conv + three dilated 3x3 convs + image pooling, projected to 256
channels; the decoder fuses the stride-4 tap (1x1 -> 48 channels), refines
with two 3x3 convs and upsamples the logits to the input size.  The
reference keeps one projection kernel per ASPP branch (``project0..3``,
``project_pool``) and splits the fuse conv into ``fuse1a`` (256-channel
input) and ``fuse1b`` (48-channel input); those parameters stay separate
here, and each projection runs as one conv over the channel concat with the
kernels concatenated (the same sum, one GEMM on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.models.layers import (
    Conv2d,
    ConvNormAct,
    Norm,
    dropout,
)
from semi_supervised_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear


class ASPP(nn.Module):
    def __init__(self, cin: int, features: int = 256, dilations: Sequence[int] = (6, 12, 18),
                 bn_momentum: float = 0.9, compute_dtype: torch.dtype = torch.bfloat16,
                 dropout_p: float = 0.5, norm: str = "batchnorm"):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype, norm=norm)
        self.b0 = ConvNormAct(cin, features, 1, **kw)
        for i, d in enumerate(dilations):
            setattr(self, f"b{i + 1}", ConvNormAct(cin, features, 3, dilation=d, **kw))
        self.pool = ConvNormAct(cin, features, 1, **kw)
        self.n_branches = 1 + len(dilations)
        for i in range(self.n_branches):
            setattr(self, f"project{i}", Conv2d(features, features, 1, compute_dtype=compute_dtype))
        self.project_pool = Conv2d(features, features, 1, compute_dtype=compute_dtype)
        self.project_norm = Norm(features, bn_momentum, norm)
        self.dropout_p = dropout_p
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        d = self.compute_dtype
        branches = torch.cat([getattr(self, f"b{i}")(x) for i in range(self.n_branches)], dim=1)
        wproj = torch.cat([getattr(self, f"project{i}").weight for i in range(self.n_branches)], dim=1)
        acc = F.conv2d(branches, wproj.to(d))
        pooled = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        pooled = self.project_pool(self.pool(pooled))
        acc = acc + pooled.to(acc.dtype)
        out = F.relu(self.project_norm(acc))
        return dropout(out, self.dropout_p, self.training, rng)


class DeepLabV3Plus(nn.Module):
    """Decoder over taps c2 (stride 4, low level) and c5 (ASPP)."""

    def __init__(self, num_classes: int, in_channels: int = 2048, low_channels: int = 256,
                 features: int = 256, low_level_features: int = 48,
                 dilations: Sequence[int] = (6, 12, 18), bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, norm: str = "batchnorm"):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype, norm=norm)
        self.aspp = ASPP(in_channels, features, dilations, **kw)
        self.low_project = ConvNormAct(low_channels, low_level_features, 1, **kw)
        self.fuse1a = Conv2d(features, features, 3, compute_dtype=compute_dtype)
        self.fuse1b = Conv2d(low_level_features, features, 3, compute_dtype=compute_dtype)
        self.fuse1_norm = Norm(features, bn_momentum, norm)
        self.fuse2 = ConvNormAct(features, features, 3, **kw)
        self.head = Conv2d(features, num_classes, 1, bias=True, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, taps: Dict[str, torch.Tensor], out_hw: Tuple[int, int],
                rng: Optional[object] = None) -> torch.Tensor:
        x = self.aspp(taps["c5"], rng)
        low = self.low_project(taps["c2"])
        x = resize_bilinear(x, low.shape[-2:], align_corners=False)
        w = torch.cat([self.fuse1a.weight, self.fuse1b.weight], dim=1)
        pre = F.conv2d(torch.cat([x.to(low.dtype), low], dim=1), w.to(self.compute_dtype),
                       padding=1)
        x = self.fuse2(F.relu(self.fuse1_norm(pre)))
        return resize_bilinear(self.head(x), out_hw, align_corners=False)
