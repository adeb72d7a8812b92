"""Shared plumbing of the SSL methods (counterpart of ``methods/common.py``):
the per-step generator, batch transfer, the weak / strong views and the
normalization, each taking its sampled parameters explicitly, and the
supervised loss that ``method.sup_loss`` selects."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, losses

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


def sample_weak(cfg: Config, batch: Batch, g: torch.Generator) -> augment.WeakParams:
    d = cfg.data
    return augment.sample_weak_params(g, batch["size"], d.crop_size, scale_min=d.scale_min,
                                      scale_max=d.scale_max, hflip_prob=d.hflip_prob)


def weak_view(cfg: Config, batch: Batch, params: augment.WeakParams):
    """uint8 canvas batch -> ([0,1] f32 crop NHWC, int32 labels, bool valid)."""
    d = cfg.data
    return augment.scale_crop_flip(batch["image"], batch["label"], batch["size"], params,
                                   crop_size=d.crop_size, fill_rgb=tuple(d.mean),
                                   ignore_index=d.ignore_index)


def sample_strong(cfg: Config, batch_size: int, g: torch.Generator, device) -> augment.StrongParams:
    d = cfg.data
    return augment.sample_strong_params(
        g, batch_size, device, jitter_prob=d.jitter_prob, brightness=d.jitter_brightness,
        contrast=d.jitter_contrast, saturation=d.jitter_saturation, hue=d.jitter_hue,
        grayscale_prob=d.grayscale_prob, blur_prob=d.blur_prob)


def strong_view(cfg: Config, images01: torch.Tensor, params: augment.StrongParams) -> torch.Tensor:
    return augment.strong_augment_batch(images01, params,
                                        augment.blur_kernel_size(cfg.data.crop_size))


def normalize(cfg: Config, images01: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return augment.normalize_images(images01, tuple(cfg.data.mean), tuple(cfg.data.std), dtype)


def sup_loss_fn(cfg: Config):
    """The supervised pixel loss of ``method.sup_loss``: CE with the ignore
    index, or OHEM (hard-pixel mining, the Cityscapes HRNet recipe)."""
    m, ignore = cfg.method, cfg.data.ignore_index
    if m.sup_loss == "ohem":
        return lambda logits, labels: losses.ohem_cross_entropy(
            logits, labels, ignore, m.ohem_thresh, m.ohem_min_kept)
    return lambda logits, labels: losses.cross_entropy(logits, labels, ignore)
