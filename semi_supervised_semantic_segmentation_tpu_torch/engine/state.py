"""Training state, optimizer and EMA (counterpart of ``engine/state.py``).

SGD in torch's update order -- grad += wd * param; buf = momentum * buf +
grad; param -= lr * buf -- with poly LR driven by the step counter and a
``head_lr_mult`` group for every parameter under ``decoder``, exactly the
reference's optax chain.  One SGD may hold several nets (CPS's two): each
adds its backbone and head groups, in the nets' order.  ``ema_update`` moves the teacher's parameters and
BatchNorm running statistics towards the student's.

``optim.grad_clip_norm`` clips by one global norm over every net's
gradients (:func:`clip_by_global_norm`, the reference's optax rule).

Under data parallelism (``step(..., mesh)``) the gradients are summed over
ranks before clipping and the update, in one flat buffer per dtype
(``parallel.mesh.all_reduce_grads``): a sum, because each rank's loss
already divides by the global counts.  That explicit bucket, rather than
the ``DistributedDataParallel`` wrapper, keeps one collective order on every
rank under activation checkpointing and ``torch.func.vmap`` too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.ops.schedules import poly_lr
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import Mesh, all_reduce_grads


def is_head(name: str) -> bool:
    """A parameter whose path goes through a module named ``decoder*``."""
    return any(part.startswith("decoder") for part in name.split("."))


class SGD:
    """Poly-LR momentum SGD with a backbone group and a 10x head group per
    net of ``models`` (one module, or a sequence of them)."""

    def __init__(self, cfg: Config, models: Union[nn.Module, Sequence[nn.Module]],
                 total_steps: int):
        o = cfg.optim
        if o.optimizer != "sgd":
            raise NotImplementedError(f"optim.optimizer={o.optimizer!r} is not yet ported")
        self.cfg = o
        self.total_steps = total_steps
        self.groups = []
        for model in [models] if isinstance(models, nn.Module) else models:
            named = list(model.named_parameters())
            self.groups += [([p for n, p in named if not is_head(n)], 1.0),
                            ([p for n, p in named if is_head(n)], o.head_lr_mult)]
        self.bufs: List[List[torch.Tensor]] = [
            [torch.zeros_like(p) for p in params] for params, _ in self.groups
        ]

    def lr(self, step: int) -> float:
        return poly_lr(step, self.cfg.lr, self.total_steps, self.cfg.poly_power)

    @torch.no_grad()
    def step(self, step: int, mesh: Optional[Mesh] = None) -> float:
        """Apply one update with the LR of ``step``, after summing the
        gradients over the ranks of ``mesh``; returns that LR."""
        o = self.cfg
        lr = self.lr(step)
        all_reduce_grads([p for ps, _ in self.groups for p in ps], mesh)
        if o.grad_clip_norm > 0:
            clip_by_global_norm([p.grad for ps, _ in self.groups for p in ps
                                 if p.grad is not None], o.grad_clip_norm)
        for (params, mult), bufs in zip(self.groups, self.bufs):
            if not params:
                continue
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if o.weight_decay > 0:
                grads = torch._foreach_add(grads, params, alpha=o.weight_decay)
            torch._foreach_mul_(bufs, o.momentum)
            torch._foreach_add_(bufs, grads)
            upd = torch._foreach_add(grads, bufs, alpha=o.momentum) if o.nesterov else bufs
            torch._foreach_add_(params, upd, alpha=-lr * mult)
        return lr

    def zero_grad(self) -> None:
        for params, _ in self.groups:
            for p in params:
                p.grad = None


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: g <- g / |g| * max_norm where
    the global norm |g| of every gradient (both groups of every net),
    taken in at least f32, is >= max_norm; else g unchanged.  No epsilon,
    and no host sync."""
    if not grads:
        return
    norm = torch.stack([(g.to(torch.promote_types(g.dtype, torch.float32)) ** 2).sum()
                        for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def ema_tensors(model: nn.Module) -> List[torch.Tensor]:
    """Parameters, then floating-point buffers (BN running mean and var)."""
    return list(model.parameters()) + [b for b in model.buffers() if b.is_floating_point()]


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, alpha: float) -> None:
    """theta_t <- alpha * theta_t + (1 - alpha) * theta_s, in place."""
    t, s = ema_tensors(teacher), ema_tensors(student)
    torch._foreach_mul_(t, alpha)
    torch._foreach_add_(t, s, alpha=1.0 - alpha)


@dataclass
class TrainState:
    """The student (CPS: net1), its optimizer and step; the EMA teacher of
    Mean Teacher and FixMatch, or CPS's second net (``model2``)."""

    model: nn.Module
    optimizer: SGD
    step: int = 0
    ema_model: Optional[nn.Module] = None
    model2: Optional[nn.Module] = None

    def nets(self) -> List[nn.Module]:
        """The trained nets, in the optimizer's order."""
        return [self.model] + ([self.model2] if self.model2 is not None else [])
