"""The evaluation protocol, plain PyTorch, float32.

Sliding windows of ``crop_size`` at ``eval_stride`` (a last window flush
with each edge), or the whole image; the mirrored view's softmax added,
un-mirrored; at each of ``eval_scales`` the normalized canvas resized
bilinearly to the scaled size snapped to the encoder stride 32, the
window logits summed and divided by the window count per pixel, the
probabilities resized back to the canvas and summed over scales; the
argmax against the labels in a confusion matrix (rows the label,
columns the prediction, the ignore index dropped).  Windows run one at a
time, so any canvas fits.
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.reference import augment
from port_bench.reference.layers import resize


def window_starts(size: int, crop: int, stride: int):
    if size <= crop:
        return [0]
    return sorted(set(list(range(0, size - crop, stride)) + [size - crop]))


def snap(v: float) -> int:
    return max(int(round(v / 32.0)) * 32, 32)


def _resize_nhwc(x, hw):
    return resize(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def probabilities(model, image_u8: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """Summed probabilities [N, C, H, W] of uint8 canvases [N, H, W, 3]."""
    d = cfg["data"]
    model.eval()
    x = augment.normalize_images(image_u8.float() / 255.0, tuple(d["mean"]), tuple(d["std"]),
                                 torch.float32)
    n, h, w, _ = x.shape
    crop = d["crop_size"]
    stride = d["eval_stride"] or crop * 2 // 3
    total = None
    for s in d["eval_scales"]:
        xs = x if s == 1.0 else _resize_nhwc(x, (snap(h * s), snap(w * s)))
        sh, sw = xs.shape[1], xs.shape[2]
        views = [xs] + ([xs.flip(2)] if d["eval_flip"] else [])
        p = None
        for v, xv in enumerate(views):
            if d["eval_mode"] == "sliding":
                ch, cw = min(crop, sh), min(crop, sw)
                acc = torch.zeros((n, d["num_classes"], sh, sw), device=x.device)
                cnt = torch.zeros((1, 1, sh, sw), device=x.device)
                for y0 in window_starts(sh, crop, stride):
                    for x0 in window_starts(sw, crop, stride):
                        acc[:, :, y0:y0 + ch, x0:x0 + cw] += model(
                            xv[:, y0:y0 + ch, x0:x0 + cw].contiguous())
                        cnt[:, :, y0:y0 + ch, x0:x0 + cw] += 1.0
                logits = acc / cnt.clamp_min(1.0)
            else:
                logits = model(xv)
            pv = torch.softmax(logits, dim=1)
            pv = pv.flip(3) if v == 1 else pv
            p = pv if p is None else p + pv
        p = resize(p, (h, w))
        total = p if total is None else total + p
    return total


def near_tie_share(probs: torch.Tensor, label: torch.Tensor, cfg: Dict, tau: float) -> float:
    """The share of valid pixels whose two best classes' summed
    probabilities, over the protocol's views and scales, lie within
    ``tau`` of a view's worth of each other."""
    d = cfg["data"]
    views = len(d["eval_scales"]) * (2 if d["eval_flip"] else 1)
    top = probs.topk(2, dim=1).values
    valid = label.to(probs.device) != d["ignore_index"]
    return float(((top[:, 0] - top[:, 1]) / views < tau)[valid].float().mean())


def confusion(pred: torch.Tensor, label: torch.Tensor, num_classes: int, ignore: int):
    pred, label = pred.reshape(-1).long(), label.reshape(-1).to(pred.device).long()
    valid = label != ignore
    idx = label[valid] * num_classes + pred[valid]
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)
