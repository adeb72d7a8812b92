"""U-Net decoder over the encoder's taps (counterpart of the reference's
``models/unet.py``).

At each of four steps: a x2 bilinear resize (align_corners False), the
matching encoder tap concatenated on the channel axis, two 3x3
Conv-BN-ReLU.  A 1x1 ``head`` with bias gives the per-class logits at
stride 2, and a final bilinear resize brings them to the input size, in
the compute dtype.  Module names follow the reference's parameter tree
(``up0..up3.conv1/conv2``, ``head``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from semi_supervised_semantic_segmentation_tpu_torch.models.layers import Conv2d, ConvNormAct
from semi_supervised_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, features: int, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, norm: str = "batchnorm"):
        super().__init__()
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype, norm=norm)
        self.conv1 = ConvNormAct(cin, features, 3, **kw)
        self.conv2 = ConvNormAct(features, features, 3, **kw)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
        x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2), align_corners=False)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.conv2(self.conv1(x))


class UNetDecoder(nn.Module):
    """Decoder over taps {c1 (s2), c2 (s4), c3 (s8), c4 (s16), c5 (s32)}
    with ``in_channels`` their channel counts."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 channels: Sequence[int] = (256, 128, 64, 32), bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16, norm: str = "batchnorm"):
        super().__init__()
        cin = in_channels[4]
        for i, (ch, skip) in enumerate(zip(channels, in_channels[3::-1])):
            setattr(self, f"up{i}", DecoderBlock(cin + skip, ch, bn_momentum, compute_dtype, norm))
            cin = ch
        self.head = Conv2d(cin, num_classes, 1, bias=True, compute_dtype=compute_dtype)

    def forward(self, taps: Dict[str, torch.Tensor], out_hw: Tuple[int, int],
                rng: Optional[object] = None) -> torch.Tensor:
        x = taps["c5"]
        for i, skip in enumerate((taps["c4"], taps["c3"], taps["c2"], taps["c1"])):
            x = getattr(self, f"up{i}")(x, skip)
        return resize_bilinear(self.head(x), out_hw, align_corners=False)
