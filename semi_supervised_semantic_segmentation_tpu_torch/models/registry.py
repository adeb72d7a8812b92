"""Model registry: (backbone, decoder) -> ``SegModel``.

Counterpart of the reference's ``models/registry.py`` for the backbones
ResNet-18, ResNet-50, ResNet-101 and HRNet-W48 and the decoders DeepLabV3+,
U-Net and the HRNetV2 head.  ``model.hrnet_width`` / ``model.hrnet_modules``
(default 48 and (1, 4, 3), the reference's fixed W48) size the HRNet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.models.deeplab import DeepLabV3Plus
from semi_supervised_semantic_segmentation_tpu_torch.models.hrnet import HRNet, HRNetV2Head
from semi_supervised_semantic_segmentation_tpu_torch.models.layers import keep_mask, use_mesh
from semi_supervised_semantic_segmentation_tpu_torch.models.resnet import ResNet
from semi_supervised_semantic_segmentation_tpu_torch.models.unet import UNetDecoder

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def remat_stages(remat: str) -> Tuple[int, ...]:
    """A remat plan string -> HRNet stage ids (1 = layer1)."""
    if remat in ("", "none"):
        return ()
    if remat in ("blocks", "branches"):
        return (1, 2, 3, 4)
    for prefix in ("stages:", "branches:"):
        if remat.startswith(prefix):
            return tuple(int(s) for s in remat[len(prefix):].split(",") if s)
    raise ValueError(f"unknown remat plan: {remat!r}")


class SegModel(nn.Module):
    """Encoder + decoder: NHWC image (N,H,W,3) -> NCHW logits (N,C,H,W) in
    the compute dtype.  Train mode updates BN running stats and applies the
    ASPP dropout, whose mask comes from ``rng`` (see ``layers.dropout``).
    ``mesh``: the data mesh its layers sum their batch statistics over
    (``layers.use_mesh``; None in one process)."""

    mesh = None

    def __init__(self, backbone: str = "resnet50", decoder: str = "deeplabv3plus",
                 num_classes: int = 21, output_stride: int = 16, bn_momentum: float = 0.9,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 aspp_dilations: Sequence[int] = (6, 12, 18), decoder_channels: int = 256,
                 stem_impl: str = "conv", remat: str = "", branch_conv: str = "xla",
                 head_fuse: str = "conv_first", hrnet_width: int = 48,
                 hrnet_modules: Tuple[int, int, int] = (1, 4, 3), norm: str = "batchnorm"):
        super().__init__()
        self.compute_dtype = compute_dtype
        kw = dict(bn_momentum=bn_momentum, compute_dtype=compute_dtype, norm=norm)
        if backbone in ("resnet18", "resnet50", "resnet101"):
            if remat not in ("", "none", "blocks"):
                raise ValueError(f"model.remat={remat!r} is an HRNet-only plan; use 'blocks' "
                                 f"or 'none' with backbone={backbone!r}")
            self.encoder = ResNet(backbone, output_stride if decoder == "deeplabv3plus" else 32,
                                  stem_impl=stem_impl, remat=remat == "blocks", **kw)
            chans = self.encoder.feature_channels[1:]
        elif backbone == "hrnet_w48":
            # 's2d' and 'pallas' stems are the reference's TPU formulations
            # of the same 3x3 convs; 'branches' plans checkpoint only blocks
            self.encoder = HRNet(
                hrnet_width, stage_modules=hrnet_modules, remat_stages=remat_stages(remat),
                remat_scope="branch_blocks" if remat.startswith("branches") else "module",
                branch_conv=branch_conv, **kw)
            chans = self.encoder.branch_widths
        else:
            raise NotImplementedError(f"backbone {backbone!r} is not yet ported")
        if decoder == "deeplabv3plus":
            rates = tuple(r * (16 // output_stride) for r in aspp_dilations)
            self.decoder = DeepLabV3Plus(num_classes, in_channels=chans[3], low_channels=chans[0],
                                         features=decoder_channels, dilations=rates, **kw)
        elif decoder == "hrnet_head":
            self.decoder = HRNetV2Head(num_classes, chans, fuse_order=head_fuse, **kw)
        elif decoder == "unet":
            if not backbone.startswith("resnet"):
                raise ValueError(f"decoder 'unet' takes the ResNet taps c1..c5, not {backbone!r}")
            self.decoder = UNetDecoder(num_classes, self.encoder.feature_channels, **kw)
        else:
            raise NotImplementedError(f"decoder {decoder!r} is not yet ported")

    def forward(self, x: torch.Tensor, rng: Optional[object] = None) -> torch.Tensor:
        return self.decoder(self.encoder(x), (x.shape[1], x.shape[2]), rng)

    def dropout_mask(self, n: int, h: int, w: int,
                     g: torch.Generator) -> Optional[torch.Tensor]:
        """The ASPP dropout's keep-mask for an [n, h, w, 3] input, drawn
        from ``g`` (each stride-2 layer of the ResNet rounds its size up),
        or None when the decoder draws no dropout."""
        if not isinstance(self.decoder, DeepLabV3Plus):
            return None
        aspp = self.decoder.aspp
        for _ in range(int(math.log2(self.encoder.output_stride))):
            h, w = -(-h // 2), -(-w // 2)
        return keep_mask((n, aspp.project_norm.BatchNorm_0.weight.shape[0], h, w),
                         aspp.dropout_p, g)


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


def build_model(cfg: Config, seed: Optional[int] = None, mesh=None) -> SegModel:
    """The model of ``cfg`` with random weights from ``seed`` (default
    ``train.seed``), its layers on the data ``mesh`` (``parallel.mesh``)."""
    m = cfg.model
    # 's2d' is the reference's TPU-layout formulation of the same conv, and
    # so is fuse_impl='s2d' of HRNet's stride-2 convs: both map to the plain conv.
    stem_impl = "pallas" if m.stem_impl == "pallas" else "conv"
    model = SegModel(
        backbone=m.backbone, decoder=m.decoder, num_classes=cfg.data.num_classes,
        output_stride=m.output_stride, bn_momentum=m.bn_momentum,
        compute_dtype=DTYPES[m.compute_dtype], aspp_dilations=m.aspp_dilations,
        decoder_channels=m.decoder_channels, stem_impl=stem_impl,
        remat="" if m.remat == "none" else m.remat, branch_conv=m.branch_conv,
        head_fuse=m.head_fuse, hrnet_width=m.hrnet_width, hrnet_modules=tuple(m.hrnet_modules),
        norm=m.norm,
    )
    init_weights(model, cfg.train.seed if seed is None else seed)
    use_mesh(model, mesh)
    model.mesh = mesh
    if m.pretrained:
        # ImageNet-pretrained encoder from a torchvision / official HRNet state dict
        compat.load_pretrained_encoder(m.pretrained, model)
    return model
