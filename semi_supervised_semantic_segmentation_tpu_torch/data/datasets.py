"""Datasets: VOC, Cityscapes, the synthetic blob-world fixture and the
split helpers.

Port-owned copy of the reference's ``data/datasets.py``: the host decodes
into a static uint8 canvas and records the true (h, w); every transform
runs on the device.  ``SyntheticDataset`` is byte-equal to the reference for
the same seed.  Real images are decoded by the native decoder
(``data/native_io.py``, built from ``native/decoder.cpp`` at first use); there
is no other decode path, so a machine that cannot build it cannot read them.

Layouts on disk, as the reference's:
  VOC 2012 aug:  <root>/JPEGImages/<id>.jpg, <root>/SegmentationClassAug/<id>.png
                 (or SegmentationClass/), ids from ImageSets/Segmentation/
                 <set>aug.txt or <set>.txt, else the JPEGImages listing
  Cityscapes:    <root>/leftImg8bit/<set>/<city>/<id>_leftImg8bit.png
                 <root>/gtFine/<set>/<city>/<id>_gtFine_labelTrainIds.png
                 (or _gtFine_labelIds.png, mapped through the 19-class table)
Split lists (1/16, 1/8, 1/4 labeled fractions) are read from
``<root>/splits/<split>/labeled.txt`` (+ ``unlabeled.txt``, else the
complement) and made by :func:`deterministic_split` when absent.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.data import native_io


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


def load_or_make_split(root: str, all_ids: Sequence[str], split: str):
    """The split files under ``<root>/splits/<split>/`` when present (the
    complement of ``labeled.txt`` when ``unlabeled.txt`` is absent), else
    :func:`deterministic_split`."""
    d = os.path.join(root, "splits", split)
    lab_f, unlab_f = os.path.join(d, "labeled.txt"), os.path.join(d, "unlabeled.txt")
    if not os.path.exists(lab_f):
        return deterministic_split(all_ids, split)
    with open(lab_f) as f:
        labeled = [ln.strip() for ln in f if ln.strip()]
    if os.path.exists(unlab_f):
        with open(unlab_f) as f:
            unlabeled = [ln.strip() for ln in f if ln.strip()]
    else:
        labeled_set = set(labeled)
        unlabeled = [i for i in all_ids if i not in labeled_set]
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


class _DecodedDataset(SegDataset):
    """A dataset read from disk through the native decoder: ``get_into``
    decodes straight into the canvas slot and leaves an unlabeled sample's
    label slot at its 255 fill."""

    labeled: bool

    def image_path(self, sid: str) -> str:
        raise NotImplementedError

    def decode_label(self, sid: str, lab_canvas: np.ndarray, h: int, w: int) -> None:
        raise NotImplementedError

    def get_into(self, index, img_canvas, lab_canvas):
        sid = self.ids[index]
        h, w = native_io.decode_image_into(self.image_path(sid), img_canvas)
        if self.labeled:
            self.decode_label(sid, lab_canvas, h, w)
        return h, w

    def get(self, index: int) -> Sample:
        """The sample decoded into a fresh ``canvas_hw`` slot, as its
        ``[:h, :w]`` view: an image larger than the canvas comes back
        cropped to it."""
        hc, wc = self.canvas_hw
        img = np.zeros((hc, wc, 3), np.uint8)
        lab = np.full((hc, wc), 255, np.int32)
        h, w = self.get_into(index, img, lab)
        return Sample(img[:h, :w], lab[:h, :w], (h, w), self.ids[index])


class VOCDataset(_DecodedDataset):
    """Pascal VOC 2012 aug: 21 classes, ignore 255, a square canvas
    (``max(512, crop_size)``: VOC images are at most 500 px a side)."""

    def __init__(self, root: str, ids: Sequence[str], labeled: bool = True,
                 canvas: int = 512):
        self.root = root
        self.ids = list(ids)
        self.labeled = labeled
        self.canvas_hw = (canvas, canvas)

    @staticmethod
    def list_ids(root: str, image_set: str = "train") -> List[str]:
        """The ids of ``<set>aug.txt`` (its first column's file stem: the
        reference's two-column format) or ``<set>.txt``, else of the
        JPEGImages listing."""
        for cand in (os.path.join(root, "ImageSets", "Segmentation", f"{image_set}aug.txt"),
                     os.path.join(root, "ImageSets", "Segmentation", f"{image_set}.txt")):
            if os.path.exists(cand):
                with open(cand) as f:
                    return [ln.strip().split()[0].split("/")[-1].replace(".jpg", "")
                            for ln in f if ln.strip()]
        return sorted(os.path.splitext(p)[0] for p in os.listdir(os.path.join(root, "JPEGImages")))

    def image_path(self, sid: str) -> str:
        return os.path.join(self.root, "JPEGImages", sid + ".jpg")

    def decode_label(self, sid, lab_canvas, h, w):
        for lab_dir in ("SegmentationClassAug", "SegmentationClass"):
            p = os.path.join(self.root, lab_dir, sid + ".png")
            if os.path.exists(p):
                native_io.decode_label_into(p, lab_canvas)
                return
        raise FileNotFoundError(f"no label for {sid}")


# Cityscapes' 34 label ids -> its 19 train ids (255 elsewhere), for the
# gtFine_labelIds fallback
_CITYSCAPES_ID_TO_TRAIN = np.full(256, 255, dtype=np.int32)
for _train_id, _label_id in enumerate(
        [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33]):
    _CITYSCAPES_ID_TO_TRAIN[_label_id] = _train_id


class CityscapesDataset(_DecodedDataset):
    """Cityscapes fine: 19 train classes, canvas 1024 x 2048."""

    def __init__(self, root: str, ids: Sequence[str], labeled: bool = True,
                 image_set: str = "train"):
        self.root = root
        self.ids = list(ids)
        self.labeled = labeled
        self.image_set = image_set
        self.canvas_hw = (1024, 2048)

    @staticmethod
    def list_ids(root: str, image_set: str = "train") -> List[str]:
        """``<city>/<id>`` of every ``*_leftImg8bit.png``, cities and files sorted."""
        base = os.path.join(root, "leftImg8bit", image_set)
        out = []
        for city in sorted(os.listdir(base)):
            for p in sorted(os.listdir(os.path.join(base, city))):
                if p.endswith("_leftImg8bit.png"):
                    out.append(f"{city}/{p[: -len('_leftImg8bit.png')]}")
        return out

    def image_path(self, sid: str) -> str:
        return os.path.join(self.root, "leftImg8bit", self.image_set, sid + "_leftImg8bit.png")

    def decode_label(self, sid, lab_canvas, h, w):
        gt = os.path.join(self.root, "gtFine", self.image_set, sid)
        if os.path.exists(gt + "_gtFine_labelTrainIds.png"):
            native_io.decode_label_into(gt + "_gtFine_labelTrainIds.png", lab_canvas)
            return
        native_io.decode_label_into(gt + "_gtFine_labelIds.png", lab_canvas)
        lab_canvas[:h, :w] = _CITYSCAPES_ID_TO_TRAIN[np.clip(lab_canvas[:h, :w], 0, 255)]


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
    if d.dataset == "voc":
        canvas = max(512, d.crop_size)
        if role == "val":
            return VOCDataset(d.data_root, VOCDataset.list_ids(d.data_root, "val"),
                              labeled=True, canvas=canvas)
        labeled, unlabeled = load_or_make_split(
            d.data_root, VOCDataset.list_ids(d.data_root, "train"), d.split)
        return VOCDataset(d.data_root, labeled if role == "labeled" else unlabeled,
                          labeled=(role == "labeled"), canvas=canvas)
    if d.dataset == "cityscapes":
        if role == "val":
            return CityscapesDataset(d.data_root, CityscapesDataset.list_ids(d.data_root, "val"),
                                     labeled=True, image_set="val")
        labeled, unlabeled = load_or_make_split(
            d.data_root, CityscapesDataset.list_ids(d.data_root, "train"), d.split)
        return CityscapesDataset(d.data_root, labeled if role == "labeled" else unlabeled,
                                 labeled=(role == "labeled"))
    raise ValueError(f"unknown dataset: {d.dataset}")
