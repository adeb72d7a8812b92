"""Segmentation metrics: confusion matrix and IoU (counterpart of the
reference's ``ops/metrics.py``).

The confusion matrix is an exact integer count on the device: one
flattened ``bincount`` over ``num_classes * label + pred`` with the ignored
pixels routed to an overflow bin that is sliced away.  The host sees one
(C, C) int64 array per eval pass.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """(C, C) int64 counts on ``pred``'s device; rows = ground truth,
    columns = prediction, pixels labelled ``ignore_index`` dropped."""
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).to(pred.device).long()
    valid = label != ignore_index
    idx = torch.where(valid, label * num_classes + pred,
                      torch.full_like(label, num_classes * num_classes))
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[: num_classes * num_classes].reshape(num_classes, num_classes)


def iou_from_confusion(cm) -> tuple:
    """(per-class IoU, mIoU) from a (C, C) confusion matrix.  A class with
    union 0 (absent from ground truth and prediction) is NaN and left out of
    the mean; the mIoU is 0.0 when every class is absent."""
    cm = np.asarray(cm, dtype=np.float64)
    inter = np.diag(cm)
    union = cm.sum(axis=0) + cm.sum(axis=1) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), np.nan)
    miou = float(np.nanmean(iou)) if np.any(union > 0) else 0.0
    return iou, miou


def pixel_accuracy(cm) -> float:
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    return float(np.diag(cm).sum() / total) if total > 0 else 0.0


VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)


def class_names(dataset: str, num_classes: int) -> tuple:
    if dataset == "voc" and num_classes == len(VOC_CLASSES):
        return VOC_CLASSES
    if dataset == "cityscapes" and num_classes == len(CITYSCAPES_CLASSES):
        return CITYSCAPES_CLASSES
    return tuple(f"class_{i}" for i in range(num_classes))


def format_iou_table(iou, names) -> str:
    return "\n".join(
        f"  {n:<14s} {100 * v:6.2f}" if np.isfinite(v) else f"  {n:<14s}    n/a"
        for n, v in zip(names, iou))
