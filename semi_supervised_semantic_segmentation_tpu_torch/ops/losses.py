"""Losses for the FixMatch slice (NCHW logits, computed in float32).

Counterparts of the reference's ``ops/losses.py``: ``cross_entropy`` with
ignore 255 (a masked mean that is 0, not NaN, when every pixel is ignored),
``pseudo_labels_from_logits`` and ``confidence_masked_ce`` with the "all"
denominator.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _label_logp(logits: torch.Tensor, labels_safe: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=1)
    return logp.gather(1, labels_safe.long().unsqueeze(1)).squeeze(1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """Pixel CE averaged over non-ignored pixels: (N,C,H,W) x (N,H,W)."""
    valid = labels != ignore_index
    ll = _label_logp(logits, torch.where(valid, labels, torch.zeros_like(labels)))
    mask = valid.float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def confidence_masked_ce(logits: torch.Tensor, pseudo_labels: torch.Tensor,
                         conf_mask: torch.Tensor, ignore_index: int = 255,
                         normalize: str = "all") -> torch.Tensor:
    """FixMatch CE on pseudo-labeled pixels above the confidence bar.

    ``"all"`` divides by the count of valid (non-ignore) pixels, so
    low-confidence pixels count in the denominator; ``"masked"`` divides by
    the confident ones only."""
    valid = pseudo_labels != ignore_index
    keep = valid & conf_mask.bool()
    ll = _label_logp(logits, torch.where(keep, pseudo_labels, torch.zeros_like(pseudo_labels)))
    keepf = keep.float()
    denom = valid.float().sum() if normalize == "all" else keepf.sum()
    return -(ll * keepf).sum() / denom.clamp(min=1.0)


def pseudo_labels_from_logits(teacher_logits: torch.Tensor, conf_thresh: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,C,H,W) logits -> (int32 argmax labels, bool max-prob > tau)."""
    probs = F.softmax(teacher_logits.float(), dim=1)
    conf, labels = probs.max(dim=1)
    return labels.to(torch.int32), conf > conf_thresh
