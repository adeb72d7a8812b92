"""Model weights made from the seed on the device, in one large draw.

Conv kernels: lecun-normal (std sqrt(1 / fan_in), scaled by 1 / 0.8796 and
cut at 2 std, the program's own initialisation scheme); conv biases zero;
BatchNorm scale 1 and shift 0.  The running statistics of every BatchNorm
come from a calibration batch (the traffic's first images, cropped to the
training crop, through the reference model in training mode), so that an
eval-mode forward, the EMA teacher's or the evaluator's, scales its
activations as a trained net's are scaled, rather than passing them on at
the size to which they grow through a deep net.  The traffic file's
``state`` says how (``running_stats``): ``centered``, the batch's mean and
variance, or ``zero_mean``, a mean of 0 and the batch's second moment about
0, which leaves an eval-mode BatchNorm no mean to subtract: in bfloat16 that
cancellation leaves an activation mostly rounding error where its mean is
large beside its spread, and the teacher's confidence (and so its
pseudo-labels) then turns on rounding.  ``state.gain`` scales named kernels:
the classifier, so that the teacher is confident on part of the pixels, as
a trained teacher is, and the pseudo-label path of the step does its work
(HRNet-W48 at 8x: 0.4-78 % of them at the 0.95 bar, by seed).  The state is made once a run and the same state goes to the
program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.reference import augment
from port_bench.reference.layers import BatchNorm
from port_bench.reference.models import build, state_shapes


def make_state(shapes: List[Tuple[str, tuple]], seed: int, device,
               gain: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """The drawn state dict for ``shapes`` from ``seed`` (running
    statistics 0 and 1); ``gain`` scales named kernels."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 4 + 1)
    kernels = [(n, s) for n, s in shapes if len(s) == 4]
    flat = torch.randn(sum(math.prod(s) for _, s in kernels), generator=g, device=device)
    out, at = {}, 0
    for name, shape in kernels:
        n = math.prod(shape)
        std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
        std *= (gain or {}).get(name, 1.0)
        out[name] = (flat[at:at + n] * std).clamp_(-2 * std, 2 * std).reshape(shape)
        at += n
    for name, shape in shapes:
        if len(shape) != 4:
            ones = name.endswith("BatchNorm_0.weight") or name.endswith("running_var")
            out[name] = (torch.ones if ones else torch.zeros)(shape, device=device)
    return {name: out[name] for name, _ in shapes}


@torch.no_grad()
def cell_state(cell, seed: int, images_u8: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The state of ``cell``'s model for ``seed``: drawn, then its running
    statistics set from ``images_u8`` [n, H, W, 3] (cropped to the training
    crop from the top left) in float32, as the traffic's ``state`` says.
    On the host."""
    cfg, how = cell.config["config"], cell.traffic["state"]
    classes, crop = cfg["data"]["num_classes"], cfg["data"]["crop_size"]
    state = make_state(state_shapes(cfg["model"], classes), seed, device, how["gain"])
    model = build(cfg["model"], classes).to(device)
    model.load_state_dict(state)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0
    x = torch.from_numpy(np.ascontiguousarray(images_u8[:, :crop, :crop])).to(device)
    d = cfg["data"]
    model.train()
    model(augment.normalize_images(x.float() / 255.0, tuple(d["mean"]), tuple(d["std"]),
                                   torch.float32))
    if how["running_stats"] == "zero_mean":
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_var += m.running_mean ** 2
                m.running_mean.zero_()
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
