"""Models: ResNet encoders, DeepLabV3+ decoder, registry."""

from semi_supervised_semantic_segmentation_tpu_torch.models.registry import SegModel, build_model

__all__ = ["SegModel", "build_model"]
