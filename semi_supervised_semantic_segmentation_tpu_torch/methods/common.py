"""Shared plumbing of the methods (counterpart of ``methods/common.py``):
the per-step generator, batch transfer, the weak / strong views and the
normalization, each taking its sampled parameters explicitly, the
supervised loss that ``method.sup_loss`` selects, and the train state with
an EMA teacher.

Under data parallelism (``mesh``) every rank seeds the same generator and
draws each parameter for the GLOBAL batch, in the order one process would,
and keeps its own rows, as the reference draws the global batch from one
key; the step's scalars are summed over ranks (:func:`global_scalars`)."""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.engine.state import SGD, TrainState
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, losses
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    concat_rows,
    launches,
    row_block,
    size,
)

Batch = Dict[str, torch.Tensor]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """Deterministic per-step generator seeded from (train.seed, step): the
    counterpart of the reference's ``fold_in(key, step)``, so the same seed
    gives the same augmentation stream after a restart."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return g


def to_device(batch: Dict[str, np.ndarray], device, non_blocking: bool = False) -> Batch:
    """Host uint8/int32 numpy batch -> tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=non_blocking)
    return out


def sample_weak(cfg: Config, batch: Batch, g: torch.Generator,
                mesh: Optional[Mesh] = None) -> augment.WeakParams:
    d = cfg.data
    return augment.sample_weak_params(g, batch["size"], d.crop_size, scale_min=d.scale_min,
                                      scale_max=d.scale_max, hflip_prob=d.hflip_prob,
                                      rows=row_block(mesh, batch["size"].shape[0]))


def weak_view(cfg: Config, batch: Batch, params: augment.WeakParams):
    """uint8 canvas batch -> ([0,1] f32 crop NHWC, int32 labels, bool valid)."""
    d = cfg.data
    return augment.scale_crop_flip(batch["image"], batch["label"], batch["size"], params,
                                   crop_size=d.crop_size, fill_rgb=tuple(d.mean),
                                   ignore_index=d.ignore_index)


def sample_strong(cfg: Config, batch_size: int, g: torch.Generator, device,
                  mesh: Optional[Mesh] = None) -> augment.StrongParams:
    d = cfg.data
    total, rows = row_block(mesh, batch_size)
    p = augment.sample_strong_params(
        g, total, device, jitter_prob=d.jitter_prob, brightness=d.jitter_brightness,
        contrast=d.jitter_contrast, saturation=d.jitter_saturation, hue=d.jitter_hue,
        grayscale_prob=d.grayscale_prob, blur_prob=d.blur_prob)
    return p if total == batch_size else augment.StrongParams(
        **{f.name: getattr(p, f.name)[rows] for f in dataclasses.fields(p)})


def sample_boxes(cfg: Config, batch_size: int, g: torch.Generator, device,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """CutMix boxes (``augment.cutmix_boxes``) of this rank's rows."""
    c = cfg.data.crop_size
    total, rows = row_block(mesh, batch_size)
    u = torch.rand(total, 4, generator=g, device=device)[rows]
    return augment.cutmix_boxes(u, c, c, cfg.method.cutmix_prob)


def dropout_keep(model, g: torch.Generator, crop: int, *local: int,
                 mesh: Optional[Mesh] = None) -> Optional[torch.Tensor]:
    """The ASPP dropout's keep-mask for a forward of the concatenated
    batches of ``local`` rows each: drawn from ``g`` for the global
    concatenation and cut to this rank's rows (``parallel.mesh.concat_rows``);
    None where the decoder has no dropout, or where no ``model`` is given
    (the caller then sets the mask itself)."""
    if model is None:
        return None
    keep = model.dropout_mask(sum(local) * size(mesh), crop, crop, g)
    if keep is None or size(mesh) == 1:
        return keep
    return keep[concat_rows(mesh, *local).to(keep.device)]


def global_scalars(out: Dict[str, object], keys: Iterable[str],
                   mesh: Optional[Mesh] = None) -> Dict[str, object]:
    """The step's ``keys`` (0-d f32 tensors, each this rank's share) summed
    over ranks in one packed ``all_reduce``: the global batch's values."""
    keys = list(keys)
    if not launches(mesh):
        return out
    packed = all_reduce_sum(torch.stack([out[k] for k in keys]), mesh)
    return {**out, **dict(zip(keys, packed.unbind(0)))}


def fraction(mask: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's share of the global fraction of True in ``mask``: the
    mean in one process, the local count over the global size otherwise."""
    m = mask.float()
    return m.mean() if size(mesh) == 1 else m.sum() / (m.numel() * mesh.size)


def strong_view(cfg: Config, images01: torch.Tensor, params: augment.StrongParams) -> torch.Tensor:
    return augment.strong_augment_batch(images01, params,
                                        augment.blur_kernel_size(cfg.data.crop_size))


def normalize(cfg: Config, images01: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return augment.normalize_images(images01, tuple(cfg.data.mean), tuple(cfg.data.std), dtype)


def sup_loss_fn(cfg: Config, mesh: Optional[Mesh] = None):
    """The supervised pixel loss of ``method.sup_loss``: CE with the ignore
    index, or OHEM (hard-pixel mining, the Cityscapes HRNet recipe), with
    global normalisers under ``mesh``."""
    m, ignore = cfg.method, cfg.data.ignore_index
    if m.sup_loss == "ohem":
        return lambda logits, labels: losses.ohem_cross_entropy(
            logits, labels, ignore, m.ohem_thresh, m.ohem_min_kept, mesh=mesh)
    return lambda logits, labels: losses.cross_entropy(logits, labels, ignore, mesh=mesh)


def state_with_teacher(cfg: Config, model: torch.nn.Module, total_steps: int) -> TrainState:
    """SGD on ``model`` and an EMA teacher: a frozen copy in eval mode."""
    teacher = copy.deepcopy(model).eval()
    for p in teacher.parameters():
        p.requires_grad_(False)
    return TrainState(model=model, optimizer=SGD(cfg, model, total_steps), ema_model=teacher)
