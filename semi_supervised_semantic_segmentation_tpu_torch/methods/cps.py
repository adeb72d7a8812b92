"""Cross-pseudo-supervision (config 4), after the reference's ``methods/cps.py``:
two nets of one architecture, each supervised on the labeled view and each
supervising the other with its argmax pseudo-labels on both views:

  L = sup(p1[:nl], y) + sup(p2[:nl], y)
      + cps_weight * (CPS(l1^l, l2^l, lvalid) + CPS(l1^u, l2^u, uvalid))

with ``sup`` CE or OHEM (``method.sup_loss``) and the geometric valid masks
keeping the padding out of the pseudo-supervision.  One SGD holds both nets
(param groups net1 backbone, net1 head, net2 backbone, net2 head), which
for SGD is the reference's one optax chain over ``{'net1', 'net2'}``.

Net1 is the caller's model (``build_model(cfg)``: seed ``train.seed``);
:func:`init_state` builds net2 as ``build_model(cfg, seed=train.seed + 1)``
on net1's device.  With ``model.pretrained`` both load the same encoder.

``method.cps_impl``:

- ``separate``: two forwards over ``cat([xl, xu])``, one backward of the
  summed loss;
- ``stacked``: one forward of both nets under ``torch.func.vmap`` over a
  leading net axis of their stacked parameters and BatchNorm buffers
  (:func:`stacked_forward`), the counterpart of the reference's ``jax.vmap``
  over stacked params; each conv then runs as one grouped conv.  The
  stem kernels run once per net (``ops.stem.StemConvBN.vmap``).  A piece
  that ``vmap`` cannot carry raises: ``stacked`` never runs ``separate``.
  A ``model.remat`` plan checkpoints nothing here (``layers.remat_active``:
  ``torch.utils.checkpoint`` cannot run inside ``vmap``), so ``stacked``
  keeps every activation whatever the plan; the values are the plan's.

Every random parameter of a step is drawn up front (:func:`draw`) from a
generator seeded by (``train.seed``, step), in the reference's order: weak_l,
weak_u, then the ASPP dropout keep-mask of net1 and of net2 (bool tensors,
so that both forms take the same draws); a caller may pass its own
:class:`Draws` instead, as the tests do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call, vmap

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.engine.state import SGD, TrainState
from semi_supervised_semantic_segmentation_tpu_torch.methods import common
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model, layers
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, losses
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import Mesh

uses_unlabeled = True
uses_ema = False


@dataclass
class Draws:
    weak_l: augment.WeakParams
    weak_u: augment.WeakParams
    dropout1: Optional[torch.Tensor]  # bool keep-mask of net1's ASPP output; None: no dropout
    dropout2: Optional[torch.Tensor]


def draw(cfg: Config, model, labeled: common.Batch, unlabeled: common.Batch,
         g: torch.Generator, mesh: Optional[Mesh] = None) -> Draws:
    """The step's draws; under ``mesh`` the global batch's, each rank
    keeping its rows (``common``; the keep-masks' rows of the global
    ``[labeled; unlabeled]``)."""
    weak_l = common.sample_weak(cfg, labeled, g, mesh)
    weak_u = common.sample_weak(cfg, unlabeled, g, mesh)
    rows = (cfg.data.crop_size, labeled["image"].shape[0], unlabeled["image"].shape[0])
    return Draws(weak_l=weak_l, weak_u=weak_u,
                 dropout1=common.dropout_keep(model, g, *rows, mesh=mesh),
                 dropout2=common.dropout_keep(model, g, *rows, mesh=mesh))


def init_state(cfg: Config, model: torch.nn.Module, total_steps: int) -> TrainState:
    model2 = build_model(cfg, seed=cfg.train.seed + 1,
                         mesh=model.mesh).to(next(model.parameters()).device)
    return TrainState(model=model, optimizer=SGD(cfg, [model, model2], total_steps),
                      model2=model2)


def stacked_forward(net1: torch.nn.Module, net2: torch.nn.Module, x: torch.Tensor,
                    keep1: Optional[torch.Tensor], keep2: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both nets' train-mode forwards of ``x`` as one ``vmap`` of net1's
    ``functional_call`` over the nets' parameters and buffers stacked on a
    leading axis (``torch.func.stack_module_state``'s layout, stacked in the
    autograd graph so that the gradients reach each net's own parameters).
    The BatchNorm running statistics the forward updates in the stacked
    buffers are copied back to each net; BatchNorm normalizes a bf16 input
    in f32 under ``vmap`` (``layers.vmapped``).  -> (logits1, logits2)."""
    if (keep1 is None) != (keep2 is None):
        raise ValueError("stacked CPS needs a dropout keep-mask for both nets or for neither")
    p2, b2 = dict(net2.named_parameters()), dict(net2.named_buffers())
    params = {n: torch.stack([p, p2[n]]) for n, p in net1.named_parameters()}
    with torch.no_grad():
        buffers = {n: torch.stack([b, b2[n]]) for n, b in net1.named_buffers()}
    keeps = None if keep1 is None else torch.stack([keep1, keep2])

    def one(p, b, keep):
        return functional_call(net1, (p, b), (x, keep))

    with layers.vmapped():
        logits = vmap(one, in_dims=(0, 0, None if keeps is None else 0))(params, buffers, keeps)
    with torch.no_grad():
        for n, b in net1.named_buffers():
            b.copy_(buffers[n][0])
            b2[n].copy_(buffers[n][1])
    return logits[0], logits[1]


def make_train_step(cfg: Config, total_steps: int, mesh: Optional[Mesh] = None):
    """The step on this rank's rows of both global batches under ``mesh``
    (``fixmatch`` docstring); the returned losses are global."""
    m = cfg.method
    ignore = cfg.data.ignore_index
    sup_fn = common.sup_loss_fn(cfg, mesh)
    stacked = m.cps_impl == "stacked"

    def train_step(state: TrainState, labeled: common.Batch, unlabeled: common.Batch,
                   draws: Optional[Draws] = None) -> Dict[str, object]:
        net1, net2 = state.model, state.model2
        dtype = net1.compute_dtype
        if draws is None:
            g = common.step_generator(cfg.train.seed, state.step, unlabeled["image"].device)
            draws = draw(cfg, net1, labeled, unlabeled, g, mesh)
        xl01, y, lvalid = common.weak_view(cfg, labeled, draws.weak_l)
        xu01, _, uvalid = common.weak_view(cfg, unlabeled, draws.weak_u)
        x = torch.cat([common.normalize(cfg, xl01, dtype), common.normalize(cfg, xu01, dtype)])
        nl = xl01.shape[0]

        net1.train()
        net2.train()
        if stacked:
            logits1, logits2 = stacked_forward(net1, net2, x, draws.dropout1, draws.dropout2)
        else:
            logits1, logits2 = net1(x, draws.dropout1), net2(x, draws.dropout2)
        sup = sup_fn(logits1[:nl], y) + sup_fn(logits2[:nl], y)
        cps = (losses.cps_loss(logits1[:nl], logits2[:nl], ignore, lvalid, mesh)
               + losses.cps_loss(logits1[nl:], logits2[nl:], ignore, uvalid, mesh))
        loss = sup + m.cps_weight * cps
        state.optimizer.zero_grad()
        loss.backward()
        lr = state.optimizer.step(state.step, mesh)
        state.step += 1
        return common.global_scalars(
            {"loss": loss.detach(), "sup_loss": sup.detach(), "cps_loss": cps.detach(),
             "lr": lr}, ("loss", "sup_loss", "cps_loss"), mesh)

    return train_step
