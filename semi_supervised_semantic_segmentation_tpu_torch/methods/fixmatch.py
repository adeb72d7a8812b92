"""FixMatch-style pseudo-labeling with CutMix (configs 3 and 5).

Follows the reference's ``methods/fixmatch.py`` step:
  weak views of both batches; strong view of the unlabeled one;
  EMA teacher (eval mode, no grad) on the weak view -> argmax + confidence;
  padding -> ignore BEFORE CutMix; CutMix of the strong image, pseudo-label
  and confidence with the roll-by-1 partner, then normalize (kernel A when
  ``data.cutmix_impl=pallas``);
  one student forward over [labeled; mixed]; CE or OHEM + lambda * masked CE;
  SGD; EMA update of parameters and BN running statistics.

Every random parameter of a step is drawn up front (:func:`draw`) from a
generator seeded by (``train.seed``, step); a caller may pass its own
:class:`Draws` instead, which is how tests inject a CutMix box and a
dropout mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.engine.state import TrainState, ema_update
from semi_supervised_semantic_segmentation_tpu_torch.methods import common
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, losses
from semi_supervised_semantic_segmentation_tpu_torch.ops.cutmix_normalize import cutmix_normalize
from semi_supervised_semantic_segmentation_tpu_torch.ops.schedules import consistency_weight

uses_unlabeled = True
uses_ema = True


@dataclass
class Draws:
    weak_l: augment.WeakParams
    weak_u: augment.WeakParams
    strong: augment.StrongParams
    boxes: torch.Tensor  # (B,4) int32 CutMix boxes (y1, y2, x1, x2)
    dropout: object  # torch.Generator, or a bool keep-mask of the ASPP output


def draw(cfg: Config, labeled: common.Batch, unlabeled: common.Batch,
         g: torch.Generator) -> Draws:
    dev = unlabeled["image"].device
    b = unlabeled["image"].shape[0]
    c = cfg.data.crop_size
    return Draws(
        weak_l=common.sample_weak(cfg, labeled, g),
        weak_u=common.sample_weak(cfg, unlabeled, g),
        strong=common.sample_strong(cfg, b, g, dev),
        boxes=augment.cutmix_boxes(torch.rand(b, 4, generator=g, device=dev), c, c,
                                   cfg.method.cutmix_prob),
        dropout=g,
    )


def init_state(cfg: Config, model: torch.nn.Module, total_steps: int) -> TrainState:
    return common.state_with_teacher(cfg, model, total_steps)


def make_train_step(cfg: Config, total_steps: int):
    m = cfg.method
    sup_fn = common.sup_loss_fn(cfg)
    ignore = cfg.data.ignore_index
    mean, std = tuple(cfg.data.mean), tuple(cfg.data.std)

    def train_step(state: TrainState, labeled: common.Batch, unlabeled: common.Batch,
                   draws: Optional[Draws] = None) -> Dict[str, object]:
        model, teacher = state.model, state.ema_model
        dtype = model.compute_dtype
        if draws is None:
            g = common.step_generator(cfg.train.seed, state.step, unlabeled["image"].device)
            draws = draw(cfg, labeled, unlabeled, g)
        xl01, y, _ = common.weak_view(cfg, labeled, draws.weak_l)
        xu01, _, uvalid = common.weak_view(cfg, unlabeled, draws.weak_u)
        xu_strong01 = common.strong_view(cfg, xu01, draws.strong)

        teacher.eval()
        with torch.no_grad():
            teacher_logits = teacher(common.normalize(cfg, xu01, dtype))
        pseudo, conf = losses.pseudo_labels_from_logits(teacher_logits, m.conf_thresh)
        # Mean-fill padding is fake imagery: ignore it before CutMix so mixed-in
        # padding stays out of the unsupervised loss.
        pseudo = torch.where(uvalid, pseudo, torch.full_like(pseudo, ignore))

        xl = common.normalize(cfg, xl01, dtype)
        if cfg.data.cutmix_impl == "pallas":
            xu_s, pseudo, conf = cutmix_normalize(
                xu_strong01.contiguous(), pseudo.contiguous(), conf.contiguous(),
                draws.boxes.contiguous(), mean, std, dtype)
        else:
            mixed, pseudo, conf = augment.cutmix_batch(xu_strong01, pseudo, conf, draws.boxes)
            xu_s = common.normalize(cfg, mixed, dtype)
        nl = xl.shape[0]
        lam = consistency_weight(state.step, m.consistency_weight, m.rampup_iters, m.rampup_kind)

        model.train()
        logits = model(torch.cat([xl, xu_s], dim=0), draws.dropout)
        sup = sup_fn(logits[:nl], y)
        unsup = losses.confidence_masked_ce(logits[nl:], pseudo, conf, ignore, normalize="all")
        loss = sup + lam * unsup
        state.optimizer.zero_grad()
        loss.backward()
        lr = state.optimizer.step(state.step)
        ema_update(teacher, model, m.ema_alpha)
        state.step += 1
        return {
            "loss": loss.detach(),
            "sup_loss": sup.detach(),
            "unsup_loss": unsup.detach(),
            "mask_ratio": conf.float().mean(),
            "consistency_weight": lam,
            "lr": lr,
        }

    return train_step
