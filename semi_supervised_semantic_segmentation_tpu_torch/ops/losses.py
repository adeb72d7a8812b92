"""Losses for the FixMatch slices (NCHW logits, computed in float32).

Counterparts of the reference's ``ops/losses.py``: ``cross_entropy`` with
ignore 255 (a masked mean that is 0, not NaN, when every pixel is ignored),
``ohem_cross_entropy``, ``pseudo_labels_from_logits`` and
``confidence_masked_ce`` with the "all" denominator.
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


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                       thresh: float = 0.7, min_kept: int = 100000) -> torch.Tensor:
    """Online hard example mining CE (the official OhemCrossEntropy): keep
    the valid pixels whose true-class probability is below max(thresh, p_k),
    p_k the min(min_kept, n_valid - 1)-th smallest such probability, and
    average their CE.  p_k is found on the device (:func:`kth_smallest_nonneg_f32`),
    so the step never waits for the host."""
    valid = labels != ignore_index
    ll = _label_logp(logits, torch.where(valid, labels, torch.zeros_like(labels)))
    pix_loss = torch.where(valid, -ll, torch.zeros_like(ll))
    p_true = ll.detach().exp()
    flat_p = torch.where(valid, p_true, torch.full_like(p_true, float("inf"))).reshape(-1)
    n_valid = valid.sum()
    idx = torch.clamp(torch.clamp(n_valid - 1, max=min_kept), 0, flat_p.numel() - 1)
    threshold = torch.clamp(kth_smallest_nonneg_f32(flat_p, idx), min=thresh)
    kept = valid & (p_true < threshold)
    return (pix_loss * kept).sum() / kept.sum().clamp(min=1)


def kth_smallest_nonneg_f32(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th smallest (0-based; ``k`` a 0-d integer tensor) of a flat
    f32 tensor of non-negative values (+inf allowed).  Their IEEE bit
    patterns order as the values do, so a 32-step binary search over the bit
    space finds it, each step one counting reduction: no sort, and no host
    round trip for ``k`` (``torch.kthvalue`` takes a Python int)."""
    bits = x.float().contiguous().view(torch.int32)
    rank = (k + 1).to(torch.int64)  # smallest u with count(bits <= u) >= rank
    lo = torch.zeros((), dtype=torch.int64, device=x.device)
    hi = torch.full((), 0x7F800000, dtype=torch.int64, device=x.device)  # +inf
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        take = (bits <= mid.to(torch.int32)).sum() >= rank
        lo, hi = torch.where(take, lo, mid + 1), torch.where(take, mid, hi)
    return lo.to(torch.int32).view(torch.float32)
