"""ResNet-18/50/101 encoders (torchvision v1.5, dilated for DeepLab); the
BasicBlock also builds HRNet's branches.

Counterpart of the reference's ``models/resnet.py``: stride on the 3x3
conv of the bottleneck; output stride 16 moves layer4's stride into
dilation 2 (block 0 keeps dilation 1), output stride 8 also layer3's.
Takes an NHWC image, returns NCHW taps c1 (stride 2, post-stem ReLU),
c2 (s4), c3 (s8), c4, c5.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.models.layers import (
    ConvNormAct,
    StemSegment,
    checkpoint,
    remat_active,
)


class BasicBlock(nn.Module):
    """Two 3x3 Conv-BN (stride and dilation on the first) with an identity
    or 1x1 Conv-BN ``downsample`` shortcut: ResNet-18's block, and with
    stride 1 and no downsample HRNet's branch block.  ``fused=True`` is the
    reference's NCHW branch flow (stride 1, dilation 1, no downsample only):
    both convs run through ``ConvNormAct.raw`` (kernels D and E on the
    card), conv1's BatchNorm + ReLU is applied inside conv2's kernel, and
    conv2's BatchNorm is applied before the residual.  Same math and
    parameters either way."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, norm: str = "batchnorm"):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype, norm=norm)
        self.conv1 = ConvNormAct(cin, planes, 3, stride=stride, dilation=dilation, **kw)
        self.conv2 = ConvNormAct(planes, planes, 3, dilation=dilation, act=False, **kw)
        self.downsample = (ConvNormAct(cin, planes, 1, stride=stride, act=False, **kw)
                           if downsample else None)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        if not fused:
            identity = self.downsample(x) if self.downsample is not None else x
            return F.relu(self.conv2(self.conv1(x)) + identity)
        y1, fold1 = self.conv1.raw(x)
        y2, (mul2, add2) = self.conv2.raw(y1, fold1)
        d = self.compute_dtype
        out = y2 * mul2.to(d)[None, :, None, None] + add2.to(d)[None, :, None, None]
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, norm: str = "batchnorm"):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype, norm=norm)
        out = planes * self.expansion
        self.conv1 = ConvNormAct(cin, planes, 1, **kw)
        self.conv2 = ConvNormAct(planes, planes, 3, stride=stride, dilation=dilation, **kw)
        self.conv3 = ConvNormAct(planes, out, 1, act=False, **kw)
        self.downsample = (ConvNormAct(cin, out, 1, stride=stride, act=False, **kw)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


_SPECS = {"resnet18": (BasicBlock, (2, 2, 2, 2)), "resnet50": (Bottleneck, (3, 4, 6, 3)),
          "resnet101": (Bottleneck, (3, 4, 23, 3))}


class ResNet(nn.Module):
    """ResNet encoder returning the taps c1..c5.  ``remat`` (the
    ``model.remat: blocks`` plan) checkpoints each residual block in
    training, as the reference's ``nn.remat(block_cls)``; the stem stays
    outside."""

    def __init__(self, arch: str = "resnet50", output_stride: int = 32,
                 bn_momentum: float = 0.9, compute_dtype: torch.dtype = torch.bfloat16,
                 stem_impl: str = "conv", norm: str = "batchnorm", remat: bool = False):
        super().__init__()
        if arch not in _SPECS:
            raise NotImplementedError(f"backbone {arch!r} is not yet ported")
        block, layers = _SPECS[arch]
        self.expansion = block.expansion
        self.output_stride = output_stride
        self.remat = remat
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype, norm=norm)
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
            out_ch = planes * block.expansion
            for b in range(layers[stage]):
                stride = strides[stage] if b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}", block(
                    in_ch, planes, stride=stride,
                    dilation=prev_dilations[stage] if b == 0 else dilations[stage],
                    downsample=(b == 0 and (strides[stage] != 1 or in_ch != out_ch)), **kw))
                in_ch = out_ch

    @property
    def feature_channels(self) -> Tuple[int, int, int, int, int]:
        """Channels of the taps c1..c5."""
        e = self.expansion
        return (64, 64 * e, 128 * e, 256 * e, 512 * e)

    def forward(self, x_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        x, c1 = self.stem(x_nhwc)
        taps = {"c1": c1}
        remat = self.remat and remat_active(self)
        for stage in range(4):
            for b in range(self.layers[stage]):
                block = getattr(self, f"layer{stage + 1}_{b}")
                x = checkpoint(block, x) if remat else block(x)
            taps[f"c{stage + 2}"] = x
        return taps
