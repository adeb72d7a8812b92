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

Under data parallelism (``mesh``: each rank holds its rows of both global
batches) the draws are the global batch's rows (``common``), row 0's CutMix
partner is the previous rank's last row (``parallel.mesh.partner_rows``),
BatchNorm and the losses reduce over the global batch, the gradients are
summed over ranks before SGD, and the returned scalars are global.

The step and its phases are ranges of ``utils/spans.py`` (``fixmatch.step``
around ``fixmatch.draw``, ``.views``, ``.teacher``, ``.cutmix``,
``.student``, ``.loss``, ``.backward``, ``.optimizer`` and ``.ema``), no-ops
unless spans are recording.
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
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import Mesh, partner_rows
from semi_supervised_semantic_segmentation_tpu_torch.utils.spans import span

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
         g: torch.Generator, model=None, mesh: Optional[Mesh] = None) -> Draws:
    """The step's draws (the global batch's rows under ``mesh``;
    ``common``)."""
    dev = unlabeled["image"].device
    nl, b = labeled["image"].shape[0], unlabeled["image"].shape[0]
    return Draws(
        weak_l=common.sample_weak(cfg, labeled, g, mesh),
        weak_u=common.sample_weak(cfg, unlabeled, g, mesh),
        strong=common.sample_strong(cfg, b, g, dev, mesh),
        boxes=common.sample_boxes(cfg, b, g, dev, mesh),
        dropout=common.dropout_keep(model, g, cfg.data.crop_size, nl, b, mesh=mesh),
    )


def init_state(cfg: Config, model: torch.nn.Module, total_steps: int) -> TrainState:
    return common.state_with_teacher(cfg, model, total_steps)


def make_train_step(cfg: Config, total_steps: int, mesh: Optional[Mesh] = None):
    m = cfg.method
    sup_fn = common.sup_loss_fn(cfg, mesh)
    ignore = cfg.data.ignore_index
    mean, std = tuple(cfg.data.mean), tuple(cfg.data.std)

    def train_step(state: TrainState, labeled: common.Batch, unlabeled: common.Batch,
                   draws: Optional[Draws] = None) -> Dict[str, object]:
        with span("fixmatch.step"):
            return _train_step(state, labeled, unlabeled, draws)

    def _train_step(state, labeled, unlabeled, draws):
        model, teacher = state.model, state.ema_model
        dtype = model.compute_dtype
        with span("fixmatch.draw"):
            if draws is None:
                g = common.step_generator(cfg.train.seed, state.step, unlabeled["image"].device)
                draws = draw(cfg, labeled, unlabeled, g, model, mesh)
        with span("fixmatch.views"):
            xl01, y, _ = common.weak_view(cfg, labeled, draws.weak_l)
            xu01, _, uvalid = common.weak_view(cfg, unlabeled, draws.weak_u)
            xu_strong01 = common.strong_view(cfg, xu01, draws.strong)

        with span("fixmatch.teacher"):
            teacher.eval()
            with torch.no_grad():
                teacher_logits = teacher(common.normalize(cfg, xu01, dtype))
            pseudo, conf = losses.pseudo_labels_from_logits(teacher_logits, m.conf_thresh)
            # Mean-fill padding is fake imagery: ignore it before CutMix so mixed-in
            # padding stays out of the unsupervised loss.
            pseudo = torch.where(uvalid, pseudo, torch.full_like(pseudo, ignore))

        with span("fixmatch.cutmix"):
            xl = common.normalize(cfg, xl01, dtype)
            xu_strong01, pseudo, conf = (t.contiguous() for t in (xu_strong01, pseudo, conf))
            partner = partner_rows((xu_strong01, pseudo, conf), mesh)
            if cfg.data.cutmix_impl == "pallas":
                xu_s, pseudo, conf = cutmix_normalize(
                    xu_strong01, pseudo, conf, draws.boxes.contiguous(), mean, std, dtype,
                    partner)
            else:
                mixed, pseudo, conf = augment.cutmix_batch(xu_strong01, pseudo, conf,
                                                           draws.boxes, partner)
                xu_s = common.normalize(cfg, mixed, dtype)
        nl = xl.shape[0]
        lam = consistency_weight(state.step, m.consistency_weight, m.rampup_iters, m.rampup_kind)

        with span("fixmatch.student"):
            model.train()
            logits = model(torch.cat([xl, xu_s], dim=0), draws.dropout)
        with span("fixmatch.loss"):
            sup = sup_fn(logits[:nl], y)
            unsup = losses.confidence_masked_ce(logits[nl:], pseudo, conf, ignore,
                                                normalize="all", mesh=mesh)
            loss = sup + lam * unsup
        with span("fixmatch.backward"):
            state.optimizer.zero_grad()
            loss.backward()
        with span("fixmatch.optimizer"):
            lr = state.optimizer.step(state.step, mesh)
        with span("fixmatch.ema"):
            ema_update(teacher, model, m.ema_alpha)
        state.step += 1
        return common.global_scalars({
            "loss": loss.detach(),
            "sup_loss": sup.detach(),
            "unsup_loss": unsup.detach(),
            "mask_ratio": common.fraction(conf, mesh),
            "consistency_weight": lam,
            "lr": lr,
        }, ("loss", "sup_loss", "unsup_loss", "mask_ratio"), mesh)

    return train_step
