"""Model registry: (backbone, decoder) -> ``SegModel``.

Counterpart of the reference's ``models/registry.py`` for ResNet-50 +
DeepLabV3+; other backbones and decoders raise until their slice is ported
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
from semi_supervised_semantic_segmentation_tpu_torch.models.resnet import ResNet

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class SegModel(nn.Module):
    """Encoder + decoder: NHWC image (N,H,W,3) -> NCHW logits (N,C,H,W) in
    the compute dtype.  Train mode updates BN running stats and applies the
    ASPP dropout, whose mask comes from ``rng`` (see ``layers.dropout``)."""

    def __init__(self, backbone: str = "resnet50", decoder: str = "deeplabv3plus",
                 num_classes: int = 21, output_stride: int = 16, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 aspp_dilations: Sequence[int] = (6, 12, 18), decoder_channels: int = 256,
                 stem_impl: str = "conv"):
        super().__init__()
        if backbone != "resnet50":
            raise NotImplementedError(f"backbone {backbone!r} is not yet ported")
        if decoder != "deeplabv3plus":
            raise NotImplementedError(f"decoder {decoder!r} is not yet ported")
        self.compute_dtype = compute_dtype
        self.encoder = ResNet(backbone, output_stride, bn_momentum, compute_dtype, stem_impl)
        rates = tuple(r * (16 // output_stride) for r in aspp_dilations)
        self.decoder = DeepLabV3Plus(num_classes, features=decoder_channels, dilations=rates,
                                     bn_momentum=bn_momentum, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, rng: Optional[object] = None) -> torch.Tensor:
        return self.decoder(self.encoder(x), (x.shape[1], x.shape[2]), rng)


def init_weights(model: nn.Module, seed: int) -> None:
    """Random init from ``seed``: conv kernels lecun-normal (truncated at 2
    std, the reference's flax default), biases zero, BN scale 1 / bias 0."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                w = mod.weight
                std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
                w.copy_(torch.empty(w.shape).normal_(0.0, std, generator=g).clamp_(-2 * std, 2 * std))
                if mod.bias is not None:
                    mod.bias.zero_()


def build_model(cfg: Config, seed: Optional[int] = None) -> SegModel:
    m = cfg.model
    if m.norm != "batchnorm":
        raise NotImplementedError(f"model.norm={m.norm!r} is not yet ported")
    if m.remat not in ("", "none"):
        raise NotImplementedError(f"model.remat={m.remat!r} is not yet ported")
    # 's2d' is the reference's TPU-layout formulation of the same conv.
    stem_impl = "pallas" if m.stem_impl == "pallas" else "conv"
    model = SegModel(
        backbone=m.backbone, decoder=m.decoder, num_classes=cfg.data.num_classes,
        output_stride=m.output_stride, bn_momentum=m.bn_momentum,
        compute_dtype=DTYPES[m.compute_dtype], aspp_dilations=m.aspp_dilations,
        decoder_channels=m.decoder_channels, stem_impl=stem_impl,
    )
    init_weights(model, cfg.train.seed if seed is None else seed)
    if m.pretrained:
        raise NotImplementedError("model.pretrained is not yet ported (ROADMAP.md Queue 1 item 2)")
    return model
