"""The FixMatch + CutMix training step, plain PyTorch, float32.

It follows the published recipe as the configurations state it: weak views
of both batches, a strong view of the unlabeled one, the EMA teacher
(eval mode, no gradient) on the weak unlabeled view, argmax pseudo-labels
with a confidence bar, padding set to ignore before CutMix, CutMix of the
strong image, pseudo-label and confidence with the roll-by-1 partner, one
student forward over [labeled; mixed], CE or OHEM plus the masked CE
divided by every valid pixel, momentum SGD (weight decay added to the
gradient) with the poly rate and a 10x rate for every parameter under the
decoder, and the EMA of the parameters and the BatchNorm statistics.

The step's random parameters come from one generator per step, seeded
from (seed, step) as the program seeds its own and drawn in the program's
order (weak labeled, weak unlabeled, strong, CutMix boxes, ASPP dropout),
so that the same calls on the same device give the same numbers.

``fault`` plants a fault of the kind the benchmark's check has to catch:
``half_batch`` takes both losses over the first half of their rows alone;
``pseudo_shift`` moves each pseudo-label to the next class where the
teacher produces it; ``grad_double`` doubles the first parameter's
gradient where the backward produces it.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from port_bench.reference import augment

FAULTS = ("half_batch", "pseudo_shift", "grad_double")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return g


def poly_lr(step: int, base: float, total: int, power: float) -> float:
    frac = min(max(step / max(total, 1), 0.0), 1.0)
    return base * (1.0 - frac) ** power


def _label_logp(logits, labels):
    return F.log_softmax(logits, dim=1).gather(1, labels.long().unsqueeze(1)).squeeze(1)


def cross_entropy(logits, labels, ignore):
    valid = labels != ignore
    ll = _label_logp(logits, torch.where(valid, labels, torch.zeros_like(labels)))
    mask = valid.float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def ohem_cross_entropy(logits, labels, ignore, thresh, min_kept):
    """Keep the valid pixels whose true-class probability is below
    max(thresh, p_k), p_k the min(min_kept, n_valid - 1)-th smallest of
    them (0-based), and average their CE."""
    valid = labels != ignore
    ll = _label_logp(logits, torch.where(valid, labels, torch.zeros_like(labels)))
    pix = torch.where(valid, -ll, torch.zeros_like(ll))
    p = ll.detach().exp()
    flat = torch.where(valid, p, torch.full_like(p, float("inf"))).reshape(-1)
    k = int(min(max(int(valid.sum()) - 1, 0), min_kept, flat.numel() - 1))
    kth = torch.kthvalue(flat, k + 1).values
    kept = valid & (p < torch.clamp(kth, min=thresh))
    return (pix * kept).sum() / kept.sum().clamp(min=1)


def masked_ce(logits, pseudo, conf, ignore):
    """The masked CE on confident pseudo-labels, over every valid pixel."""
    valid = pseudo != ignore
    keep = valid & conf
    ll = _label_logp(logits, torch.where(keep, pseudo, torch.zeros_like(pseudo)))
    return -(ll * keep.float()).sum() / valid.float().sum().clamp(min=1.0)


def is_head(name: str) -> bool:
    return any(part.startswith("decoder") for part in name.split("."))


class FixMatchReference:
    """A student, its EMA teacher and the SGD state, stepped by :meth:`step`.
    ``cfg`` is a configuration file's ``config`` dict, ``total_steps`` the
    schedule's length, ``seed`` the program's ``train.seed``."""

    def __init__(self, model: torch.nn.Module, cfg: Dict, total_steps: int, seed: int,
                 fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.total, self.seed, self.fault = cfg, total_steps, seed, fault
        self.model = model
        self.teacher = copy.deepcopy(model).eval()
        for p in self.teacher.parameters():
            p.requires_grad_(False)
        self.named = list(model.named_parameters())
        self.bufs = [torch.zeros_like(p) for _, p in self.named]
        self.step_index = 0

    def draws(self, lab, unlab, device):
        d, c = self.cfg["data"], self.cfg["data"]["crop_size"]
        g = step_generator(self.seed, self.step_index, device)
        weak = dict(scale_min=d["scale_min"], scale_max=d["scale_max"], hflip_prob=d["hflip_prob"])
        nl, b = lab["image"].shape[0], unlab["image"].shape[0]
        weak_l = augment.sample_weak_params(g, lab["size"], c, **weak)
        weak_u = augment.sample_weak_params(g, unlab["size"], c, **weak)
        strong = augment.sample_strong_params(
            g, b, device, jitter_prob=d["jitter_prob"], brightness=d["jitter_brightness"],
            contrast=d["jitter_contrast"], saturation=d["jitter_saturation"], hue=d["jitter_hue"],
            grayscale_prob=d["grayscale_prob"], blur_prob=d["blur_prob"])
        boxes = augment.cutmix_boxes(torch.rand(b, 4, generator=g, device=device), c, c,
                                     self.cfg["method"]["cutmix_prob"])
        shape = self.model.dropout_shape(nl + b, c, c)
        keep = None if shape is None else torch.rand(shape, generator=g, device=device) < 0.5
        return weak_l, weak_u, strong, boxes, keep

    def step(self, lab: Dict[str, torch.Tensor], unlab: Dict[str, torch.Tensor]) -> Dict:
        """One step on device batches (uint8 NHWC canvases, int32 labels and
        sizes).  Returns the loss and, on the first step, the gradient of
        every parameter as SGD receives it."""
        cfg, d, m = self.cfg, self.cfg["data"], self.cfg["method"]
        dev = unlab["image"].device
        ignore, crop = d["ignore_index"], d["crop_size"]
        mean, std = tuple(d["mean"]), tuple(d["std"])
        weak_l, weak_u, strong, boxes, keep = self.draws(lab, unlab, dev)
        view = dict(crop_size=crop, fill_rgb=mean, ignore_index=ignore)
        xl01, y, _ = augment.scale_crop_flip(lab["image"], lab["label"], lab["size"], weak_l, **view)
        xu01, _, uvalid = augment.scale_crop_flip(unlab["image"], unlab["label"], unlab["size"],
                                                  weak_u, **view)
        xu_strong = augment.strong_augment_batch(xu01, strong, augment.blur_kernel_size(crop))
        f32 = torch.float32
        with torch.no_grad():
            probs = torch.softmax(self.teacher(augment.normalize_images(xu01, mean, std, f32)), 1)
        conf, pseudo = probs.max(dim=1)
        pseudo, conf = pseudo.to(torch.int32), conf > m["conf_thresh"]
        if self.fault == "pseudo_shift":
            pseudo = (pseudo + 1) % d["num_classes"]
        pseudo = torch.where(uvalid, pseudo, torch.full_like(pseudo, ignore))
        mixed, pseudo, conf = augment.cutmix_batch(xu_strong, pseudo, conf, boxes)
        x = torch.cat([augment.normalize_images(xl01, mean, std, f32),
                       augment.normalize_images(mixed, mean, std, f32)])
        nl, nu = xl01.shape[0], mixed.shape[0]
        self.model.train()
        logits = self.model(x, keep)
        sup_rows, unsup_rows = slice(0, nl), slice(nl, nl + nu)
        if self.fault == "half_batch":
            sup_rows, unsup_rows = slice(0, nl // 2), slice(nl, nl + nu // 2)
            y, pseudo, conf = y[: nl // 2], pseudo[: nu // 2], conf[: nu // 2]
        if m["sup_loss"] == "ohem":
            sup = ohem_cross_entropy(logits[sup_rows], y, ignore, m["ohem_thresh"],
                                     m["ohem_min_kept"])
        else:
            sup = cross_entropy(logits[sup_rows], y, ignore)
        unsup = masked_ce(logits[unsup_rows], pseudo, conf, ignore)
        loss = sup + self._consistency() * unsup
        for _, p in self.named:
            p.grad = None
        loss.backward()
        if self.fault == "grad_double":
            self.named[0][1].grad.mul_(2.0)
        out = {"loss": float(loss.detach()), "sup": float(sup.detach()),
               "unsup": float(unsup.detach()), "mask": float(conf.float().mean())}
        if self.step_index == 0:
            out["grads"] = {n: p.grad.detach().clone() for n, p in self.named}
        self._sgd()
        self._ema()
        self.step_index += 1
        return out

    def _consistency(self) -> float:
        m = self.cfg["method"]
        n = m["rampup_iters"]
        if n <= 0:
            return m["consistency_weight"]
        t = min(max(self.step_index / n, 0.0), 1.0)
        ramp = math.exp(-5.0 * (1.0 - t) ** 2) if m["rampup_kind"] == "sigmoid" else t
        return m["consistency_weight"] * ramp

    @torch.no_grad()
    def _sgd(self) -> None:
        o = self.cfg["optim"]
        lr = poly_lr(self.step_index, o["lr"], self.total, o["poly_power"])
        for (name, p), buf in zip(self.named, self.bufs):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = g + o["weight_decay"] * p
            buf.mul_(o["momentum"]).add_(g)
            upd = g + o["momentum"] * buf if o["nesterov"] else buf
            p.sub_(lr * (o["head_lr_mult"] if is_head(name) else 1.0) * upd)

    @torch.no_grad()
    def _ema(self) -> None:
        a = self.cfg["method"]["ema_alpha"]

        def tensors(model) -> List[torch.Tensor]:
            return list(model.parameters()) + [b for b in model.buffers() if b.is_floating_point()]

        for t, s in zip(tensors(self.teacher), tensors(self.model)):
            t.mul_(a).add_(s, alpha=1.0 - a)
