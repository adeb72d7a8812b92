"""Mean Teacher (config 2), after the reference's ``methods/mean_teacher.py``:
  weak views of both batches; strong view of the unlabeled one;
  EMA teacher (eval mode, no grad) on the weak unlabeled view;
  one student forward over [labeled; strong unlabeled];
  CE or OHEM + lambda(step) * softmax-MSE consistency against the teacher,
  padding pixels masked out, reduced as ``method.consistency_reduction``;
  SGD; EMA update of parameters and BN running statistics.

Every random parameter of a step is drawn up front (:func:`draw`) from a
generator seeded by (``train.seed``, step); a caller may pass its own
:class:`Draws` instead, as the tests do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.engine.state import TrainState, ema_update
from semi_supervised_semantic_segmentation_tpu_torch.methods import common
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, losses
from semi_supervised_semantic_segmentation_tpu_torch.ops.schedules import consistency_weight

uses_unlabeled = True
uses_ema = True


@dataclass
class Draws:
    weak_l: augment.WeakParams
    weak_u: augment.WeakParams
    strong: augment.StrongParams
    dropout: object  # torch.Generator, or a bool keep-mask of the ASPP output


def draw(cfg: Config, labeled: common.Batch, unlabeled: common.Batch,
         g: torch.Generator) -> Draws:
    dev = unlabeled["image"].device
    return Draws(weak_l=common.sample_weak(cfg, labeled, g),
                 weak_u=common.sample_weak(cfg, unlabeled, g),
                 strong=common.sample_strong(cfg, unlabeled["image"].shape[0], g, dev),
                 dropout=g)


def init_state(cfg: Config, model: torch.nn.Module, total_steps: int) -> TrainState:
    return common.state_with_teacher(cfg, model, total_steps)


def make_train_step(cfg: Config, total_steps: int):
    m = cfg.method
    sup_fn = common.sup_loss_fn(cfg)

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
        xl = common.normalize(cfg, xl01, dtype)
        xu_s = common.normalize(cfg, xu_strong01, dtype)
        nl = xl.shape[0]
        lam = consistency_weight(state.step, m.consistency_weight, m.rampup_iters, m.rampup_kind)

        model.train()
        logits = model(torch.cat([xl, xu_s], dim=0), draws.dropout)
        sup = sup_fn(logits[:nl], y)
        # padding pixels (mean fill outside the scaled content) carry no
        # signal: the valid mask keeps them out of the consistency
        unsup = losses.mse_consistency(logits[nl:], teacher_logits, valid_mask=uvalid,
                                       reduction=m.consistency_reduction)
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
            "consistency_weight": lam,
            "lr": lr,
        }

    return train_step
