"""Supervised-only method (config 1), after the reference's
``methods/supervised.py``: weak view of the labeled batch, normalize, one
forward/backward, CE or OHEM (``method.sup_loss``), SGD with poly LR.

Every random parameter of a step is drawn up front (:func:`draw`) from a
generator seeded by (``train.seed``, step); a caller may pass its own
:class:`Draws` instead, as the tests do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.engine.state import SGD, TrainState
from semi_supervised_semantic_segmentation_tpu_torch.methods import common
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment

uses_unlabeled = False
uses_ema = False


@dataclass
class Draws:
    weak_l: augment.WeakParams
    dropout: object  # torch.Generator, or a bool keep-mask of the ASPP output


def draw(cfg: Config, labeled: common.Batch, g: torch.Generator) -> Draws:
    return Draws(weak_l=common.sample_weak(cfg, labeled, g), dropout=g)


def init_state(cfg: Config, model: torch.nn.Module, total_steps: int) -> TrainState:
    return TrainState(model=model, optimizer=SGD(cfg, model, total_steps))


def make_train_step(cfg: Config, total_steps: int):
    sup_fn = common.sup_loss_fn(cfg)

    def train_step(state: TrainState, labeled: common.Batch,
                   unlabeled: Optional[common.Batch] = None,
                   draws: Optional[Draws] = None) -> Dict[str, object]:
        model = state.model
        if draws is None:
            g = common.step_generator(cfg.train.seed, state.step, labeled["image"].device)
            draws = draw(cfg, labeled, g)
        x01, y, _ = common.weak_view(cfg, labeled, draws.weak_l)
        model.train()
        loss = sup_fn(model(common.normalize(cfg, x01, model.compute_dtype), draws.dropout), y)
        state.optimizer.zero_grad()
        loss.backward()
        lr = state.optimizer.step(state.step)
        state.step += 1
        loss = loss.detach()
        return {"loss": loss, "sup_loss": loss, "lr": lr}

    return train_step
