"""The one traffic generator: synthetic images and labels at the real
canvas shapes, made on the device from the seed in a few large calls and
held on the host, where the program's loader threads copy them into its
canvases.

A traffic file (``traffic/<name>.json``) gives:

- ``loop``: ``train`` (labeled and unlabeled batches through the trainer)
  or ``eval`` (val batches through the evaluator);
- ``canvas``: [H, W] of the loader's uint8 canvas;
- ``image_sizes``: the true (h, w) of the images, a fixed set that every
  seed uses, assigned to the images in an order drawn from the seed;
- ``label_cell``: the side of the square cells of one class each that tile
  a label map; ``ignore_share``: the share of cells labelled 255;
- ``labeled_pool``, ``unlabeled_pool``, ``val_pool``: how many distinct
  images each dataset holds (its length);
- ``trace_steps``: steps (or val batches) profiled in a ``--trace 1`` run;
- ``check_batches``: val batches the reference recomputes, and
  ``near_tie``: the margin, in a view's worth of probability, under which
  the reference's two best classes count as nearly tied (eval loop);
- ``state``: how the weights are made (:mod:`port_bench.weights`).

An image is its label map's class colours (a palette drawn from the seed)
blended with uniform noise, so every pixel differs between images.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

STREAMS = {"labeled": 1, "unlabeled": 2, "val": 3}


class PoolDataset:
    """A dataset of ``len(images)`` samples, as the program's loader reads
    one: ``canvas_hw``, ``__len__`` and ``get_into``."""

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray], sizes: np.ndarray):
        self.images, self.labels, self.sizes = images, labels, sizes
        self.canvas_hw = tuple(images.shape[1:3])

    def __len__(self) -> int:
        return len(self.images)

    def get_into(self, index: int, img_canvas: np.ndarray, lab_canvas: np.ndarray):
        h, w = (int(v) for v in self.sizes[index])
        img_canvas[:h, :w] = self.images[index, :h, :w]
        if self.labels is not None:
            lab_canvas[:h, :w] = self.labels[index, :h, :w]
        return h, w

    def assemble(self, indices) -> Dict[str, np.ndarray]:
        """The batch the program's loader assembles from ``indices`` (index
        -1: a blank slot), for the reference."""
        hc, wc = self.canvas_hw
        b = len(indices)
        out = {"image": np.zeros((b, hc, wc, 3), np.uint8),
               "label": np.full((b, hc, wc), 255, np.int32),
               "size": np.zeros((b, 2), np.int32)}
        for slot, i in enumerate(indices):
            if i < 0:
                out["size"][slot] = (1, 1)
                continue
            out["size"][slot] = self.get_into(int(i), out["image"][slot], out["label"][slot])
        return out

    def valid_pixels(self, indices) -> int:
        """Pixels of ``indices`` whose label is not ignored."""
        if self.labels is None:
            return 0
        total = 0
        for i in indices:
            if i >= 0:
                h, w = (int(v) for v in self.sizes[i])
                total += int((self.labels[i, :h, :w] != 255).sum())
        return total


def make_dataset(traffic: Dict, role: str, num_classes: int, seed: int,
                 device) -> PoolDataset:
    """The ``role`` dataset (``labeled``, ``unlabeled`` or ``val``) of
    ``traffic`` for ``seed``; unlabeled images carry no labels."""
    n = traffic[f"{role}_pool"]
    h, w = traffic["canvas"]
    cell = traffic["label_cell"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * len(STREAMS) + STREAMS[role])
    gh, gw = math.ceil(h / cell), math.ceil(w / cell)
    classes = torch.randint(0, num_classes, (n, gh, gw), generator=g, device=device)
    ignored = torch.rand((n, gh, gw), generator=g, device=device) < traffic["ignore_share"]
    palette = torch.randint(0, 256, (num_classes, 3), generator=g, device=device,
                            dtype=torch.int16)
    noise = torch.randint(0, 256, (n, h, w, 3), generator=g, device=device, dtype=torch.uint8)
    order = torch.randperm(n, generator=g, device=device).cpu().numpy()

    def up(t):
        return t.repeat_interleave(cell, 1).repeat_interleave(cell, 2)[:, :h, :w]

    colour = palette[up(classes)]
    images = ((colour * 3 + noise.to(torch.int16) * 2) // 5).to(torch.uint8).cpu().numpy()
    labels = None
    if role != "unlabeled":
        labels = up(torch.where(ignored, torch.full_like(classes, 255), classes))
        labels = labels.to(torch.int32).cpu().numpy()
    table: List = traffic["image_sizes"]
    sizes = np.asarray([table[o % len(table)] for o in order], np.int32)
    return PoolDataset(images, labels, sizes)
