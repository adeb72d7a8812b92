"""Peaks of the card, and the work the model needs: its FLOPs, and the
bytes and FLOPs of the convs that the program's hand-written kernels run.

The least time of a piece of work is the larger of its FLOPs over the
bf16 peak and its bytes over the memory bandwidth, with each input read
once and each output written once (bf16 activations, float32 weights and
statistics).  A kernel's roofline share is that least time over the
device time of the kernels that do the work.  The counts are of the work
the model needs, whatever kernel implements it: the recomputation of a
checkpointed forward is not counted.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

# The H100 SXM's published dense peaks (NVIDIA's data sheet, 700 W):
# bytes/s of HBM3 and bf16 FLOP/s.
H100 = ("H100 80GB HBM3", 3.35e12, 989e12)


def peaks(device_name: str) -> Tuple[float, float]:
    """(bytes/s, bf16 FLOP/s) of the card named ``device_name``."""
    name, bw, flops = H100
    if name not in device_name:
        raise ValueError(f"no published peaks for {device_name!r}")
    return bw, flops


def least_seconds(nbytes: float, flops: float, device_name: str) -> float:
    bw, peak = peaks(device_name)
    return max(nbytes / bw, flops / peak)


BF16, F32 = 2, 4


def stem_work(n: int, side: int, backward: bool) -> List[Tuple[float, float]]:
    """(bytes, FLOPs) of ResNet's 7x7 stride-2 stem conv with its BatchNorm
    statistics on n NHWC images of ``side``^2 (forward: x read, y and the
    [2, 64] statistics written); with ``backward`` also its weight
    gradient with the statistics' cotangent folded in (x, dy and y and the
    statistics' cotangent read, dW written)."""
    out = (side + 1) // 2
    x, y = n * side * side * 3 * BF16, n * 64 * out * out * BF16
    w, stats = 64 * 3 * 49 * F32, 2 * 64 * F32
    flops = 2.0 * n * 64 * out * out * 3 * 49
    work = [(x + w + y + stats, flops)]
    if backward:
        work.append((x + 2 * y + stats + w, flops))
    return work


def branch_conv_work(n: int, c: int, h: int, w: int, mode: str) -> Tuple[float, float]:
    """(bytes, FLOPs) of one stride-1 3x3 conv at C in = C out = c on
    [n, c, h, w] bf16, by ``mode``: ``fwd`` (x, the weights and an optional
    BatchNorm-ReLU of x read; y and its statistics written), ``dx`` (dy
    read, dx written), ``dx_post`` (dy and x read, dx and the gradient of
    x's BatchNorm written), ``dw`` (x, dy, y and the statistics' cotangent
    read; the composed dy and dW written)."""
    t = n * c * h * w * BF16
    wt, vec = c * c * 9 * F32, 2 * c * F32
    flops = 2.0 * n * c * c * 9 * h * w
    tensors = {"fwd": 2, "dx": 2, "dx_post": 3, "dw": 4}[mode]
    return tensors * t + wt + 2 * vec, flops


def seconds(work: Iterable[Tuple[float, float]], device_name: str) -> float:
    return sum(least_seconds(b, f, device_name) for b, f in work)


def hrnet_branch_shapes(model_cfg: Dict, n: int, h: int, w: int) -> List[Tuple[int, int, int]]:
    """(C, H, W) of each stride-1 3x3 conv of HRNet's branches that the
    program's fused branch kernels take (C <= 128, H a multiple of 32),
    once per conv of one forward on [n, h, w] images."""
    width, modules = model_cfg["hrnet_width"], model_cfg["hrnet_modules"]
    out = []
    for stage, count in zip((2, 3, 4), modules):
        for i in range(stage):
            c, bh, bw = width * 2 ** i, h // 4 // 2 ** i, w // 4 // 2 ** i
            if c <= 128 and bh % 32 == 0 and bh >= 32:
                out += [(c, bh, bw)] * (count * 4 * 2)
    return out


def model_flops(model_cfg: Dict, num_classes: int,
                passes: List[Tuple[str, int, int, int]]) -> float:
    """FLOPs that ``torch.utils.flop_counter`` counts over the reference
    model for ``passes``: (kind, n, h, w) with kind ``fwd`` (eval forward)
    or ``train`` (training forward and backward), on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference.models import build

    with torch.device("meta"):
        model = build(model_cfg, num_classes)
    total = 0.0
    for kind, n, h, w in passes:
        x = torch.empty((n, h, w, 3), device="meta")
        with FlopCounterMode(display=False) as counter:
            if kind == "fwd":
                model.eval()
                with torch.no_grad():
                    model(x)
            else:
                model.train()
                shape = model.dropout_shape(n, h, w)
                keep = None if shape is None else torch.ones(shape, dtype=torch.bool,
                                                             device="meta")
                model(x, keep).sum().backward()
        total += counter.get_total_flops()
    return float(total)


def _window_starts(size: int, crop: int, stride: int) -> List[int]:
    if size <= crop:
        return [0]
    return sorted(set(list(range(0, size - crop, stride)) + [size - crop]))


def _snap(v: float) -> int:
    return max(int(round(v / 32.0)) * 32, 32)


def eval_windows(cfg: Dict, canvas_hw: Tuple[int, int]) -> List[Tuple[int, int, int]]:
    """(forwards per image, h, w) of the eval protocol of configuration
    ``cfg`` on one ``canvas_hw`` image: per scale (its canvas snapped to
    the stride 32), every window of every view."""
    d = cfg["data"]
    views = 2 if d["eval_flip"] else 1
    out = []
    for s in d["eval_scales"]:
        h, w = canvas_hw if s == 1.0 else (_snap(canvas_hw[0] * s), _snap(canvas_hw[1] * s))
        if d["eval_mode"] != "sliding":
            out.append((views, h, w))
            continue
        crop, stride = d["crop_size"], d["eval_stride"] or d["crop_size"] * 2 // 3
        k = len(_window_starts(h, crop, stride)) * len(_window_starts(w, crop, stride))
        out.append((views * k, min(crop, h), min(crop, w)))
    return out


def train_passes(cfg: Dict) -> List[Tuple[str, int, int, int]]:
    """The model passes of one FixMatch step: the teacher's forward on the
    unlabeled batch, the student's forward and backward on both."""
    t, c = cfg["train"], cfg["data"]["crop_size"]
    nl, nu = t["labeled_batch_size"], t["unlabeled_batch_size"]
    return [("fwd", nu, c, c), ("train", nl + nu, c, c)]
