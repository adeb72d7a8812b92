"""Reference models in plain PyTorch, float32, NCHW.

- DeepLabV3+ on a dilated ResNet-50 (torchvision v1.5 blocks: the stride on
  the bottleneck's 3x3 conv; output stride 16 puts layer4 on dilation 2,
  its first block on dilation 1), ASPP rates 6/12/18 with image pooling,
  dropout 0.5 on the ASPP output, the stride-4 tap projected to 48
  channels, two 3x3 convs, logits resized to the input (arXiv:1802.02611).
- HRNet-W48 (arXiv:1908.07919): two 3x3 stride-2 stem convs, layer1 of four
  bottlenecks, stages of 1, 4 and 3 modules of four basic blocks per
  branch with the cross-resolution fusion, and the HRNetV2 head (every
  branch upsampled to stride 4 and projected by its own 1x1 conv, summed,
  BatchNorm, ReLU, a 1x1 conv to the classes, logits resized to the input).

Departures from the published models, which the measured program shares:
the stem of ResNet feeds its max-pool with the post-ReLU stride-2 map and
returns the NHWC input's logits; the ASPP and decoder projections are kept
as separate parameters per input (``project0..3``, ``fuse1a``/``fuse1b``,
``fuse0..3``) and summed, which is the same map as one conv over the
channel concat; the head's ``fuse0`` has a bias.  BatchNorm is the plain
one with momentum 0.1 (torch's convention).

Parameter names are the program's, so one state dict loads into both.
``recompute`` checkpoints HRNet's stem, layer1 blocks and HR modules (the
reference runs in float32 and would not fit the card otherwise); the
arithmetic is the same either way.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.layers import (
    BatchNorm,
    Conv2d,
    ConvNormAct,
    Norm,
    Recompute,
    Rounding,
    checkpoint,
    configure,
    conv,
    exact,
    resize,
)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        out = planes * 4
        self.conv1 = ConvNormAct(cin, planes, 1)
        self.conv2 = ConvNormAct(planes, planes, 3, stride=stride, dilation=dilation)
        self.conv3 = ConvNormAct(planes, out, 1, act=False)
        self.downsample = ConvNormAct(cin, out, 1, stride=stride, act=False) if downsample else None
        self.rounding: Rounding = exact

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        return self.rounding(F.relu(self.conv3(self.conv2(self.conv1(x))) + identity))


class BasicBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = ConvNormAct(c, c, 3)
        self.conv2 = ConvNormAct(c, c, 3, act=False)
        self.rounding: Rounding = exact

    def forward(self, x):
        return self.rounding(F.relu(self.conv2(self.conv1(x)) + x))


class StemSegment(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv2d(3, 64, 7, stride=2)
        self.Norm_0 = Norm(64)

    def forward(self, x):
        c1 = F.relu(self.Norm_0(self.Conv_0(x)))
        return F.max_pool2d(c1, 3, 2, 1), c1


class ResNet50(nn.Module):
    def __init__(self, output_stride: int = 16):
        super().__init__()
        self.output_stride = output_stride
        self.stem = StemSegment()
        strides, dilations, first = [1, 2, 2, 2], [1, 1, 1, 1], [1, 1, 1, 1]
        if output_stride == 16:
            strides[3], dilations[3] = 1, 2
        elif output_stride == 8:
            strides[2], dilations[2] = 1, 2
            strides[3], dilations[3], first[3] = 1, 4, 2
        self.layers = (3, 4, 6, 3)
        cin = 64
        for s, planes in enumerate((64, 128, 256, 512)):
            for b in range(self.layers[s]):
                setattr(self, f"layer{s + 1}_{b}", Bottleneck(
                    cin, planes, stride=strides[s] if b == 0 else 1,
                    dilation=first[s] if b == 0 else dilations[s],
                    downsample=b == 0 and (strides[s] != 1 or cin != planes * 4)))
                cin = planes * 4

    def forward(self, x):
        x, c1 = self.stem(x)
        taps = {"c1": c1}
        for s in range(4):
            for b in range(self.layers[s]):
                x = getattr(self, f"layer{s + 1}_{b}")(x)
            taps[f"c{s + 2}"] = x
        return taps


class ASPP(nn.Module):
    def __init__(self, cin, features, dilations):
        super().__init__()
        self.b0 = ConvNormAct(cin, features, 1)
        for i, d in enumerate(dilations):
            setattr(self, f"b{i + 1}", ConvNormAct(cin, features, 3, dilation=d))
        self.pool = ConvNormAct(cin, features, 1)
        self.n = 1 + len(dilations)
        for i in range(self.n):
            setattr(self, f"project{i}", Conv2d(features, features, 1))
        self.project_pool = Conv2d(features, features, 1)
        self.project_norm = Norm(features)
        self.dropout_p = 0.5

    def forward(self, x, keep: Optional[torch.Tensor], rounding: Rounding):
        branches = torch.cat([getattr(self, f"b{i}")(x) for i in range(self.n)], dim=1)
        w = torch.cat([getattr(self, f"project{i}").weight for i in range(self.n)], dim=1)
        acc = conv(branches, w, rounding)
        pooled = self.project_pool(self.pool(rounding(x.mean(dim=(2, 3), keepdim=True))))
        out = F.relu(self.project_norm(acc + pooled))
        if self.training and keep is not None:
            out = torch.where(keep, out / (1.0 - self.dropout_p), torch.zeros_like(out))
        return out


class DeepLabV3Plus(nn.Module):
    def __init__(self, num_classes, dilations=(6, 12, 18)):
        super().__init__()
        self.aspp = ASPP(2048, 256, dilations)
        self.low_project = ConvNormAct(256, 48, 1)
        self.fuse1a = Conv2d(256, 256, 3)
        self.fuse1b = Conv2d(48, 256, 3)
        self.fuse1_norm = Norm(256)
        self.fuse2 = ConvNormAct(256, 256, 3)
        self.head = Conv2d(256, num_classes, 1, bias=True)
        self.rounding: Rounding = exact

    def forward(self, taps, out_hw, keep=None):
        x = self.aspp(taps["c5"], keep, self.rounding)
        low = self.low_project(taps["c2"])
        x = self.rounding(resize(x, low.shape[-2:]))
        w = torch.cat([self.fuse1a.weight, self.fuse1b.weight], dim=1)
        pre = conv(torch.cat([x, low], dim=1), w, self.rounding, padding=1)
        x = self.fuse2(F.relu(self.fuse1_norm(pre)))
        return resize(self.head(x), out_hw)


class HRModule(nn.Module):
    def __init__(self, channels: Sequence[int], blocks: int = 4):
        super().__init__()
        self.channels = tuple(channels)
        self.blocks = blocks
        n = len(channels)
        for i, c in enumerate(channels):
            for b in range(blocks):
                setattr(self, f"branch{i}_block{b}", BasicBlock(c))
        for i in range(n):
            for j in range(n):
                if j > i:
                    setattr(self, f"fuse_up_{j}_to_{i}",
                            ConvNormAct(channels[j], channels[i], 1, act=False))
                for k in range(i - j):
                    last = k == i - j - 1
                    setattr(self, f"fuse_down_{j}_to_{i}_{k}", ConvNormAct(
                        channels[j], channels[i] if last else channels[j], 3, stride=2,
                        act=not last))
        self.rounding: Rounding = exact

    def forward(self, *xs):
        n = len(self.channels)
        ys = []
        for i in range(n):
            x = xs[i]
            for b in range(self.blocks):
                x = getattr(self, f"branch{i}_block{b}")(x)
            ys.append(x)
        outs = []
        for i in range(n):
            acc = ys[i]
            for j in range(n):
                if j > i:
                    t = self.rounding(resize(getattr(self, f"fuse_up_{j}_to_{i}")(ys[j]),
                                             ys[i].shape[-2:]))
                elif j < i:
                    t = ys[j]
                    for k in range(i - j):
                        t = getattr(self, f"fuse_down_{j}_to_{i}_{k}")(t)
                else:
                    continue
                acc = acc + t
            outs.append(self.rounding(F.relu(acc)))
        return tuple(outs)


class HRNet(nn.Module):
    def __init__(self, width: int = 48, modules=(1, 4, 3)):
        super().__init__()
        w = (width, 2 * width, 4 * width, 8 * width)
        self.branch_widths = w
        self.stage_modules = tuple(modules)
        self.stem1 = ConvNormAct(3, 64, 3, stride=2)
        self.stem2 = ConvNormAct(64, 64, 3, stride=2)
        for b in range(4):
            setattr(self, f"layer1_{b}", Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0))
        self.transition1_0 = ConvNormAct(256, w[0], 3)
        self.transition1_1 = ConvNormAct(256, w[1], 3, stride=2)
        self.transition2_2 = ConvNormAct(w[1], w[2], 3, stride=2)
        self.transition3_3 = ConvNormAct(w[2], w[3], 3, stride=2)
        for stage, count in zip((2, 3, 4), self.stage_modules):
            for m in range(count):
                setattr(self, f"stage{stage}_m{m}", HRModule(w[:stage]))
        self.recompute: Optional[Recompute] = None

    def _run(self, fn, *args):
        if self.recompute is not None and self.training and torch.is_grad_enabled():
            return checkpoint(self.recompute, fn, *args)
        return fn(*args)

    def forward(self, x):
        x = self._run(lambda t: self.stem2(self.stem1(t)), x)
        for b in range(4):
            x = self._run(getattr(self, f"layer1_{b}"), x)
        xs = (self.transition1_0(x), self.transition1_1(x))
        for stage, count in zip((2, 3, 4), self.stage_modules):
            if stage == 3:
                xs = xs + (self.transition2_2(xs[-1]),)
            elif stage == 4:
                xs = xs + (self.transition3_3(xs[-1]),)
            for m in range(count):
                xs = self._run(getattr(self, f"stage{stage}_m{m}"), *xs)
        return {"c2": xs[0], "c3": xs[1], "c4": xs[2], "c5": xs[3]}


class HRNetV2Head(nn.Module):
    def __init__(self, num_classes, in_channels):
        super().__init__()
        width = sum(in_channels)
        self.fuse0 = Conv2d(in_channels[0], width, 1, bias=True)
        for i, c in enumerate(in_channels[1:]):
            setattr(self, f"fuse{i + 1}", Conv2d(c, width, 1))
        self.fuse_norm = Norm(width)
        self.head = Conv2d(width, num_classes, 1, bias=True)
        self.rounding: Rounding = exact

    def forward(self, taps, out_hw, keep=None):
        base = taps["c2"]
        hw = base.shape[-2:]
        acc = self.fuse0(base)
        for i, k in enumerate(("c3", "c4", "c5")):
            acc = acc + getattr(self, f"fuse{i + 1}")(self.rounding(resize(taps[k], hw)))
        return resize(self.head(F.relu(self.fuse_norm(acc))), out_hw)


class SegModel(nn.Module):
    """NHWC image (N, H, W, 3) -> NCHW logits (N, C, H, W), float32."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.rounding: Rounding = exact

    def forward(self, x, keep=None):
        x = self.rounding(x)
        taps = self.encoder(x.permute(0, 3, 1, 2))
        return self.rounding(self.decoder(taps, (x.shape[1], x.shape[2]), keep))

    def dropout_shape(self, n: int, h: int, w: int):
        """The ASPP dropout's keep-mask shape for an [n, h, w, 3] input, or
        None where the decoder draws none."""
        if not isinstance(self.decoder, DeepLabV3Plus):
            return None
        for _ in range(int(math.log2(self.encoder.output_stride))):
            h, w = -(-h // 2), -(-w // 2)
        return (n, 256, h, w)


def build(model_cfg: Dict, num_classes: int, rounding: Rounding = exact,
          recompute: bool = False) -> SegModel:
    """The configuration's model: ``model_cfg`` is the ``model`` section of a
    configuration file under ``port_bench/configs``."""
    backbone, decoder = model_cfg["backbone"], model_cfg["decoder"]
    if backbone == "resnet50" and decoder == "deeplabv3plus":
        os_ = model_cfg["output_stride"]
        rates = tuple(r * (16 // os_) for r in model_cfg["aspp_dilations"])
        model = SegModel(ResNet50(os_), DeepLabV3Plus(num_classes, rates))
    elif backbone == "hrnet_w48" and decoder == "hrnet_head":
        enc = HRNet(model_cfg["hrnet_width"], model_cfg["hrnet_modules"])
        model = SegModel(enc, HRNetV2Head(num_classes, enc.branch_widths))
        if recompute:
            enc.recompute = Recompute()
    else:
        raise NotImplementedError(f"no reference for {backbone} + {decoder}")
    marker = getattr(model.encoder, "recompute", None) or Recompute()
    configure(model, rounding, marker)
    return model


def state_shapes(model_cfg: Dict, num_classes: int):
    """(name, shape) of every parameter and buffer of the model, in order."""
    with torch.device("meta"):
        model = build(model_cfg, num_classes)
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def is_batchnorm_param(model: nn.Module, name: str) -> bool:
    mod = model.get_submodule(name.rsplit(".", 1)[0])
    return isinstance(mod, BatchNorm)
