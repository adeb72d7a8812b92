"""SSL methods."""

from semi_supervised_semantic_segmentation_tpu_torch.methods.registry import get_method

__all__ = ["get_method"]
