"""Datasets: the synthetic blob-world fixture and the split helpers.

Port-owned copy of the reference's numpy-only ``data/datasets.py``: the
host decodes into a static uint8 canvas and records the true (h, w); every
transform runs on the device.  ``SyntheticDataset`` is byte-equal to the
reference for the same seed.  VOC and Cityscapes are not ported yet
(ROADMAP.md, Queue 1 item 9).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from semi_supervised_semantic_segmentation_tpu_torch.config import Config


@dataclass
class Sample:
    image: np.ndarray  # (H, W, 3) uint8
    label: np.ndarray  # (H, W) int32; 255 = ignore / unlabeled
    size: Tuple[int, int]
    sample_id: str


class SegDataset:
    """Base: an indexable set of (image, label) samples with a static canvas."""

    canvas_hw: Tuple[int, int]
    ids: List[str]

    def __len__(self) -> int:
        return len(self.ids)

    def get(self, index: int) -> Sample:
        raise NotImplementedError

    def get_into(self, index: int, img_canvas: np.ndarray, lab_canvas: np.ndarray):
        """Write sample ``index`` into pre-allocated canvas slots
        ((Hc,Wc,3) uint8 / (Hc,Wc) int32 pre-filled with ignore)."""
        s = self.get(index)
        hc, wc = img_canvas.shape[:2]
        h, w = min(s.size[0], hc), min(s.size[1], wc)
        img_canvas[:h, :w] = s.image[:h, :w]
        lab_canvas[:h, :w] = s.label[:h, :w]
        return h, w


def split_fraction(split: str) -> float:
    return {"1_16": 1 / 16, "1_8": 1 / 8, "1_4": 1 / 4, "full": 1.0}[split]


def deterministic_split(ids: Sequence[str], split: str, seed: int = 0):
    """Stable labeled/unlabeled partition: sort ids by md5(seed/id), take
    the first fraction as labeled."""
    frac = split_fraction(split)
    ranked = sorted(ids, key=lambda s: hashlib.md5(f"{seed}/{s}".encode()).hexdigest())
    n_labeled = max(1, int(round(len(ids) * frac)))
    labeled = sorted(ranked[:n_labeled])
    unlabeled = sorted(ranked[n_labeled:]) if frac < 1.0 else list(labeled)
    return labeled, unlabeled


class SyntheticDataset(SegDataset):
    """Deterministic procedural 'blob world': each class paints soft-edged
    ellipses of a class-specific hue on a textured background, pixel-exact
    from (seed, index).  ``appearance_range`` rotates blob hues for the
    gapped SSL fixture."""

    APPEARANCE_SPREAD = 0.55

    def __init__(
        self,
        num_classes: int = 4,
        size: int = 64,
        image_hw: Tuple[int, int] = (96, 96),
        seed: int = 0,
        labeled: bool = True,
        cache: bool = True,
        appearance_range: Tuple[float, float] = (0.0, 0.0),
    ):
        self.num_classes = num_classes
        self.size = size
        self.canvas_hw = image_hw
        self.seed = seed
        self.labeled = labeled
        self.appearance_range = appearance_range
        self.ids = [f"syn_{seed}_{i:05d}" for i in range(size)]
        self._cache: dict = {} if cache else None

    def get(self, index: int) -> Sample:
        if self._cache is not None:
            hit = self._cache.get(index)
            if hit is not None:
                return hit
        s = self._generate(index)
        if self._cache is not None and len(self._cache) < 4096:
            self._cache[index] = s
        return s

    def _generate(self, index: int) -> Sample:
        h, w = self.canvas_hw
        rng = np.random.RandomState(self.seed * 100003 + index)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = rng.rand(h, w, 3).astype(np.float32) * 0.15 + 0.2
        label = np.zeros((h, w), dtype=np.int32)
        lo, hi = self.appearance_range
        # Appearance draws come from a separate stream so blob geometry (and
        # so the labels) is the same for every appearance range.
        arng = np.random.RandomState(self.seed * 100003 + index + 777_000_001)
        for c in range(1, self.num_classes):
            for _ in range(rng.randint(1, 3)):
                cy, cx = rng.rand(2) * [h, w]
                ry, rx = rng.rand(2) * [h / 4, w / 4] + 4
                mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
                hue = np.array(
                    [((c * 67 + k * 41) % 255) / 255.0 for k in range(3)],
                    dtype=np.float32,
                )
                if hi > lo or lo > 0.0:
                    u = arng.uniform(lo, hi)
                    hue = np.mod(hue + u * self.APPEARANCE_SPREAD, 1.0).astype(np.float32)
                img[mask] = 0.7 * hue + 0.3 * img[mask]
                label[mask] = c
        img8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        if not self.labeled:
            label = np.full((h, w), 255, dtype=np.int32)
        return Sample(img8, label, (h, w), self.ids[index])


def build_dataset(cfg: Config, role: str) -> SegDataset:
    """role: 'labeled' | 'unlabeled' | 'val'."""
    d = cfg.data
    if d.dataset == "synthetic":
        gap = d.synthetic_gapped
        full = (0.0, 1.0) if gap else (0.0, 0.0)
        narrow = (0.0, 0.25) if gap else (0.0, 0.0)
        hw = (d.synthetic_canvas,) * 2 if d.synthetic_canvas > 0 else (96, 96)
        if role == "val":
            return SyntheticDataset(d.num_classes, max(d.synthetic_size // 2, 8),
                                    image_hw=hw, seed=cfg.train.seed + 1,
                                    labeled=True, appearance_range=full)
        if role == "unlabeled":
            return SyntheticDataset(d.num_classes, d.synthetic_size, image_hw=hw,
                                    seed=cfg.train.seed + 2, labeled=False,
                                    appearance_range=full)
        n = max(1, int(round(d.synthetic_size * split_fraction(d.split))))
        return SyntheticDataset(d.num_classes, n, image_hw=hw, seed=cfg.train.seed,
                                labeled=True, appearance_range=narrow)
    if d.dataset in ("voc", "cityscapes"):
        raise NotImplementedError(
            f"data.dataset={d.dataset!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 9, real datasets and native decode); use data.dataset=synthetic"
        )
    raise ValueError(f"unknown dataset: {d.dataset}")
