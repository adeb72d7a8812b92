"""Evaluator (counterpart of the reference's ``engine/evaluator.py``).

An eval step maps (model, device batch) to a (C, C) int64 confusion matrix
on the device; ``eval_confusion`` sums them over the val loader and fetches
one matrix per pass, and ``run_eval`` turns it into IoUs.  The model runs
in eval mode (running BatchNorm statistics, no dropout) under
``torch.no_grad``.  Under data parallelism (``mesh``) each rank runs its
rows of every val batch (``val_loader``) and the pass's confusion matrix
is summed over ranks (int64, exact) before it is fetched.

Protocols, as the reference's: whole-image forwards (optionally at
``data.eval_size`` with the logits resized back), sliding windows of
``crop_size`` at ``eval_stride`` with f32 logit sums divided by the window
count, ``eval_flip`` (the mirrored view's softmax, un-mirrored, added) and
``eval_scales`` (each scale's canvas snapped to the encoder stride 32, its
probabilities resized back to the canvas and summed).  The fused path runs
the forwards one view and one window at a time; the staged path runs all
windows of all views of one scale as one batched forward (chunked by
``data.eval_window_batch``).  They do the same arithmetic and bound peak
memory differently (n images per forward against n * views * windows);
:func:`use_staged` chooses between them as the reference does.

Layouts: the canvas is NHWC (as the model's input), logits and
probabilities NCHW.  The mirror flips the image's W axis (dim 2) and the
probabilities' W axis (dim 3).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from semi_supervised_semantic_segmentation_tpu_torch.config import Config
from semi_supervised_semantic_segmentation_tpu_torch.data.datasets import build_dataset
from semi_supervised_semantic_segmentation_tpu_torch.data.pipeline import Loader
from semi_supervised_semantic_segmentation_tpu_torch.methods import common
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, metrics
from semi_supervised_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

EvalStep = Callable[[nn.Module, Dict[str, torch.Tensor]], torch.Tensor]


def _window_starts(size: int, crop: int, stride: int):
    """Sliding-window start offsets: every stride, plus a final window flush
    to the edge."""
    if size <= crop:
        return [0]
    starts = list(range(0, size - crop, stride))
    starts.append(size - crop)
    return sorted(set(starts))


def _snap(v: float) -> int:
    """Scaled eval sizes snap to the encoder stride (32)."""
    return max(int(round(v / 32.0)) * 32, 32)


def _resize_nhwc(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NHWC canvas, in its own dtype."""
    return resize_bilinear(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1).contiguous()


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=1)


def use_staged(cfg: Config) -> bool:
    """``data.eval_impl``: 'auto' takes the staged path when the fused one
    would multiply forwards (sliding windows with TTA, or more than two
    scales)."""
    if cfg.data.eval_impl == "staged":
        return True
    if cfg.data.eval_impl == "fused":
        return False
    scales = tuple(cfg.data.eval_scales)
    tta = cfg.data.eval_flip or scales != (1.0,)
    return (cfg.data.eval_mode == "sliding" and tta) or len(scales) > 2


def _normalized(cfg: Config, model: nn.Module, batch) -> torch.Tensor:
    return augment.canvas_normalize_eval(batch["image"], tuple(cfg.data.mean),
                                         tuple(cfg.data.std), model.compute_dtype)


def _with_confusion(cfg: Config, probs: EvalStep) -> EvalStep:
    """(model, batch) -> summed probabilities  =>  (model, batch) -> the
    confusion matrix of their argmax."""

    def eval_step(model, batch):
        return metrics.confusion_matrix(probs(model, batch).argmax(dim=1), batch["label"],
                                        cfg.data.num_classes, cfg.data.ignore_index)

    return eval_step


def _fused_probs(cfg: Config) -> EvalStep:
    """The fused path's (model, batch) -> summed probabilities [N, C, H, W]
    f32: one forward per view, window and scale."""
    d = cfg.data
    ncls, eval_size, crop = d.num_classes, d.eval_size, d.crop_size
    stride = d.eval_stride or (crop * 2 // 3)
    scales, flip = tuple(d.eval_scales), d.eval_flip

    def whole_logits(model, x):
        h, w = x.shape[1], x.shape[2]
        if eval_size > 0 and (h, w) != (eval_size, eval_size):
            # forward at eval_size^2, logits resized back to the label's size
            logits = model(_resize_nhwc(x, (eval_size, eval_size)))
            return resize_bilinear(logits, (h, w))
        return model(x)

    def sliding_logits(model, x):
        n, h, w, _ = x.shape
        ch, cw = min(crop, h), min(crop, w)
        acc = torch.zeros((n, ncls, h, w), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((1, 1, h, w), dtype=torch.float32, device=x.device)
        for y0 in _window_starts(h, crop, stride):
            for x0 in _window_starts(w, crop, stride):
                logits = model(x[:, y0:y0 + ch, x0:x0 + cw].contiguous())
                acc[:, :, y0:y0 + ch, x0:x0 + cw] += logits.float()
                cnt[:, :, y0:y0 + ch, x0:x0 + cw] += 1.0
        return acc / cnt.clamp_min(1.0)

    logits_fn = sliding_logits if d.eval_mode == "sliding" else whole_logits

    def single_view(model, x):
        """Probabilities at x's resolution, the mirrored view folded in."""
        p = _softmax(logits_fn(model, x))
        if flip:
            p = p + _softmax(logits_fn(model, x.flip(2))).flip(3)
        return p

    def probs(model, batch):
        x = _normalized(cfg, model, batch)
        h, w = x.shape[1], x.shape[2]
        prob = None
        for s in scales:
            if s == 1.0:
                p = single_view(model, x)
            else:
                p = single_view(model, _resize_nhwc(x, (_snap(h * s), _snap(w * s))))
                p = resize_bilinear(p, (h, w))
            prob = p if prob is None else prob + p
        return prob

    return probs


def _staged_probs(cfg: Config) -> EvalStep:
    """The staged path's summed probabilities: per scale, every window of
    every view (the mirrored canvas has the same start grid) in one batched
    forward, chunked by ``data.eval_window_batch``; the logits are
    overlap-averaged on the scaled canvas, soft-maxed, un-mirrored and
    resized to the canvas."""
    d = cfg.data
    ncls, eval_size, crop = d.num_classes, d.eval_size, d.crop_size
    stride = d.eval_stride or (crop * 2 // 3)
    scales, flip = tuple(d.eval_scales), d.eval_flip
    sliding, window_batch = d.eval_mode == "sliding", d.eval_window_batch

    def forward_chunked(model, wins):
        m = wins.shape[0]
        if window_batch <= 0 or window_batch >= m:
            return model(wins)
        return torch.cat([model(wins[i:i + window_batch]) for i in range(0, m, window_batch)])

    def scaled_prob(model, xs):
        """Probabilities on the scaled canvas xs [n, sh, sw, 3], the
        mirrored view folded in."""
        n, sh, sw, _ = xs.shape
        views = [xs] + ([xs.flip(2)] if flip else [])
        if not sliding:
            p = None
            for v, xv in enumerate(views):
                pv = _softmax(model(xv))
                pv = pv.flip(3) if v == 1 else pv
                p = pv if p is None else p + pv
            return p
        ch, cw = min(crop, sh), min(crop, sw)
        starts = [(y0, x0) for y0 in _window_starts(sh, crop, stride)
                  for x0 in _window_starts(sw, crop, stride)]
        nv, k = len(views), len(starts)
        # [n, V*K, ch, cw, 3] -> one batched forward of all views' windows
        wins = torch.stack([xv[:, y0:y0 + ch, x0:x0 + cw] for xv in views for y0, x0 in starts],
                           dim=1)
        logits = forward_chunked(model, wins.reshape(n * nv * k, ch, cw, 3))
        logits = logits.reshape(n, nv, k, ncls, ch, cw)
        cnt = torch.zeros((1, 1, sh, sw), dtype=torch.float32, device=xs.device)
        for y0, x0 in starts:
            cnt[:, :, y0:y0 + ch, x0:x0 + cw] += 1.0
        cnt = cnt.clamp_min(1.0)
        p = None
        for v in range(nv):
            acc = torch.zeros((n, ncls, sh, sw), dtype=torch.float32, device=xs.device)
            for i, (y0, x0) in enumerate(starts):
                acc[:, :, y0:y0 + ch, x0:x0 + cw] += logits[:, v, i].float()
            pv = torch.softmax(acc / cnt, dim=1)
            pv = pv.flip(3) if v == 1 else pv
            p = pv if p is None else p + pv
        return p

    def scale_contrib(model, x, s):
        """Native canvas -> this scale's probability contribution at the
        canvas' resolution."""
        h, w = x.shape[1], x.shape[2]
        if s == 1.0:
            if not sliding and eval_size > 0 and (h, w) != (eval_size, eval_size):
                # whole_logits' resize-eval protocol, then softmax (+ flip)
                p = scaled_prob(model, _resize_nhwc(x, (eval_size, eval_size)))
                return resize_bilinear(p, (h, w))
            return scaled_prob(model, x)
        p = scaled_prob(model, _resize_nhwc(x, (_snap(h * s), _snap(w * s))))
        return resize_bilinear(p, (h, w))

    def probs(model, batch):
        x = _normalized(cfg, model, batch)
        prob = None
        for s in scales:
            contrib = scale_contrib(model, x, s)
            prob = contrib if prob is None else prob + contrib
        return prob

    return probs


def make_probs(cfg: Config) -> EvalStep:
    """(model, device batch) -> the summed probabilities [N, C, H, W] f32
    of the path :func:`use_staged` picks."""
    return _staged_probs(cfg) if use_staged(cfg) else _fused_probs(cfg)


def make_evaluator(cfg: Config) -> EvalStep:
    """The eval callable (model, device batch) -> (C, C) confusion matrix:
    the staged or the fused path, per :func:`use_staged`."""
    return _with_confusion(cfg, make_probs(cfg))


def inference_model(state, method) -> nn.Module:
    """The EMA teacher when the method has one, else the student (CPS:
    net1, ``state.model``)."""
    if getattr(method, "uses_ema", False) and state.ema_model is not None:
        return state.ema_model
    return state.model


def val_loader(cfg: Config, mesh: Optional[Mesh] = None) -> Loader:
    """The val set in order, every sample once: the last batch is padded
    with blank slots (index -1, all labels ignored).  Under ``mesh`` each
    rank gets its row block of every batch of ``train.eval_batch_size``."""
    return Loader(build_dataset(cfg, "val"), cfg.train.eval_batch_size, shuffle=False,
                  drop_last=False, pad_mode="blank", num_workers=cfg.data.num_workers,
                  process_index=0 if mesh is None else mesh.rank,
                  process_count=1 if mesh is None else mesh.size)


def eval_confusion(eval_step: EvalStep, model: nn.Module, loader, device,
                   epoch: int = 0, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The (C, C) confusion matrix of one pass over the val loader, summed
    on the device (and over the ranks of ``mesh``) and fetched once.  The
    model runs in eval mode under ``torch.no_grad``; its train mode is
    restored afterwards."""
    was_training = model.training
    model.eval()
    total = None
    try:
        with torch.no_grad():
            for batch in loader.epoch(epoch):
                cm = eval_step(model, common.to_device(batch, device))
                total = cm if total is None else total + cm
    finally:
        model.train(was_training)
    return all_reduce_sum(total, mesh).cpu().numpy()


def run_eval(eval_step: EvalStep, model: nn.Module, loader, device, epoch: int = 0,
             mesh: Optional[Mesh] = None):
    """(per-class IoU, mIoU, pixel accuracy) of one pass over the val loader
    (this rank's rows of it under ``mesh``; the matrix is global)."""
    cm = eval_confusion(eval_step, model, loader, device, epoch, mesh)
    iou, miou = metrics.iou_from_confusion(cm)
    return iou, miou, metrics.pixel_accuracy(cm)


def make_predict_step(cfg: Config):
    """(model, device batch) -> int32 argmax prediction [N, H, W] of one
    plain forward on the canvas (for ``--save_preds``)."""

    def predict(model, batch):
        with torch.no_grad():
            return model(_normalized(cfg, model, batch)).argmax(dim=1).to(torch.int32)

    return predict


def voc_palette() -> np.ndarray:
    """The standard VOC colour map (bit-interleave generator), (256, 3) u8."""
    palette = np.zeros((256, 3), dtype=np.uint8)
    for i in range(256):
        lab, shift = i, 7
        r = g = b = 0
        while lab:
            r |= ((lab >> 0) & 1) << shift
            g |= ((lab >> 1) & 1) << shift
            b |= ((lab >> 2) & 1) << shift
            lab >>= 3
            shift -= 1
        palette[i] = (r, g, b)
    return palette


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_palette_png(path: str, indices: np.ndarray, palette: np.ndarray) -> None:
    """(H, W) uint8 indices + (256, 3) palette -> an 8-bit palette PNG
    (colour type 3: IHDR, PLTE, one IDAT of unfiltered rows, IEND)."""
    h, w = indices.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), indices.astype(np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)))
        f.write(_png_chunk(b"PLTE", np.ascontiguousarray(palette, np.uint8).tobytes()))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_predictions(preds, batch, dataset, out_dir: str) -> None:
    """Per-image palette PNGs, cropped to the true size, named by sample id
    (``/`` -> ``_``); blank pad slots (index < 0) are skipped."""
    os.makedirs(out_dir, exist_ok=True)
    pal = voc_palette()
    preds = preds.cpu().numpy() if torch.is_tensor(preds) else np.asarray(preds)
    index, size = np.asarray(batch["index"]), np.asarray(batch["size"])
    for i in range(preds.shape[0]):
        if int(index[i]) < 0:
            continue
        h, w = (int(v) for v in size[i])
        sid = dataset.ids[int(index[i])].replace("/", "_")
        write_palette_png(os.path.join(out_dir, f"{sid}.png"), preds[i, :h, :w], pal)
