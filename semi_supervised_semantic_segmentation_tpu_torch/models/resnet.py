"""ResNet-50 encoder (torchvision v1.5 bottlenecks, dilated for DeepLab).

Counterpart of the reference's ``models/resnet.py``: stride on the 3x3
conv of the bottleneck; output stride 16 moves layer4's stride into
dilation 2 (block 0 keeps dilation 1), output stride 8 also layer3's.
Takes an NHWC image, returns NCHW taps c1 (stride 2, post-stem ReLU),
c2 (s4), c3 (s8), c4, c5.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.models.layers import (
    ConvNormAct,
    StemSegment,
)

_SPECS = {"resnet50": (3, 4, 6, 3)}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype)
        out = planes * self.expansion
        self.conv1 = ConvNormAct(cin, planes, 1, **kw)
        self.conv2 = ConvNormAct(planes, planes, 3, stride=stride, dilation=dilation, **kw)
        self.conv3 = ConvNormAct(planes, out, 1, act=False, **kw)
        self.downsample = (ConvNormAct(cin, out, 1, stride=stride, act=False, **kw)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


class ResNet(nn.Module):
    """ResNet encoder returning the taps c1..c5."""

    def __init__(self, arch: str = "resnet50", output_stride: int = 32,
                 bn_momentum: float = 0.9, compute_dtype: torch.dtype = torch.bfloat16,
                 stem_impl: str = "conv"):
        super().__init__()
        if arch not in _SPECS:
            raise NotImplementedError(f"backbone {arch!r} is not yet ported")
        layers = _SPECS[arch]
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype)
        self.stem = StemSegment(64, 7, impl=stem_impl, **kw)
        strides = [1, 2, 2, 2]
        dilations = [1, 1, 1, 1]  # dilation of blocks 1.. of the stage
        prev_dilations = [1, 1, 1, 1]  # dilation of block 0 of the stage
        if output_stride == 16:
            strides[3], dilations[3], prev_dilations[3] = 1, 2, 1
        elif output_stride == 8:
            strides[2], dilations[2], prev_dilations[2] = 1, 2, 1
            strides[3], dilations[3], prev_dilations[3] = 1, 4, 2
        self.layers = layers
        in_ch = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            out_ch = planes * Bottleneck.expansion
            for b in range(layers[stage]):
                stride = strides[stage] if b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}", Bottleneck(
                    in_ch, planes, stride=stride,
                    dilation=prev_dilations[stage] if b == 0 else dilations[stage],
                    downsample=(b == 0 and (strides[stage] != 1 or in_ch != out_ch)), **kw))
                in_ch = out_ch

    def forward(self, x_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        x, c1 = self.stem(x_nhwc)
        taps = {"c1": c1}
        for stage in range(4):
            for b in range(self.layers[stage]):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            taps[f"c{stage + 2}"] = x
        return taps
