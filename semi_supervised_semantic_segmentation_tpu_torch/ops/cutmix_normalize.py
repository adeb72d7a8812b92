"""Fused CutMix + ImageNet-normalize: kernel A, in Triton.

Replaces ``semi_supervised_semantic_segmentation_tpu/ops/pallas_aug.py``
(``cutmix_normalize_pallas`` -> ``_kernel``).  One pass: inside sample b's
box, image, pseudo-label and confidence come from partner b-1; the image is
then normalized per channel, (x - mean) / std, and written in the model
dtype.  Row 0's partner is an input of its own (``partner``): the batch's
last row in one process, which makes it the reference's roll-by-1 partner
(b-1) mod B; under data parallelism the last row of the previous rank
(``parallel.mesh.partner_rows``), which is the global batch's roll.

The TPU kernel draws each box on chip from ``seed + b`` so that all row
tiles of a sample agree without talking to each other.  Here the step
draws 4 uniforms per sample with ``torch.rand``, a plain torch function
turns them into int32 boxes with the TPU kernel's arithmetic
(``augment.cutmix_boxes``) and the kernel takes the boxes, which gives the
same agreement and lets tests inject a box.

What bounds it on the card: no arithmetic to speak of, only bytes: at
config 3 (B=8, 512^2) ~25 MB of f32 images, 8 MB of i32 labels and 2 MB of
conf in, and 12.6 + 8 + 2 MB out -> memory-bound at ~18 us.  One program
per (sample, block of rows) reads its own rows and, only where the row
block meets the box, the partner's (masked loads), so every byte is read
and written once.
"""

from __future__ import annotations

from typing import Sequence

import torch

from semi_supervised_semantic_segmentation_tpu_torch.ops import augment

ROWS = 4  # image rows per program

# triton.language, bound on first launch (this module is imported on
# machines without triton); the kernel body below resolves ``tl`` here.
tl = None
_KERNEL = None


def _cutmix_normalize_kernel(
    img_ptr, lab_ptr, conf_ptr, box_ptr, out_img_ptr, out_lab_ptr, out_conf_ptr,
    pimg_delta, plab_delta, pconf_delta,
    H, W, m0, m1, m2, s0, s1, s2,
    ROWS: "tl.constexpr", BLOCK_C: "tl.constexpr", BLOCK_W: "tl.constexpr",
):
    b = tl.program_id(0)
    r0 = tl.program_id(1) * ROWS
    # where the partner's rows start, in elements from each tensor's start:
    # sample b-1, or for b = 0 the partner row (``p*_delta``, its distance
    # from the tensor in elements) -- one scalar per program, so every load
    # keeps its contiguous, aligned offsets
    first = b == 0
    prev = (b - 1).to(tl.int64) * H * W
    pimg_off = tl.where(first, pimg_delta, prev * 3)
    plab_off = tl.where(first, plab_delta, prev)
    pconf_off = tl.where(first, pconf_delta, prev)
    y1 = tl.load(box_ptr + b * 4)
    y2 = tl.load(box_ptr + b * 4 + 1)
    x1 = tl.load(box_ptr + b * 4 + 2)
    x2 = tl.load(box_ptr + b * 4 + 3)
    rows = r0 + tl.arange(0, ROWS)[:, None]
    row_ok = rows < H
    row_in = (rows >= y1) & (rows < y2)

    # Image: (ROWS, BLOCK_C) over the interleaved W*3 values of each row.
    w3 = W * 3
    cols = tl.arange(0, BLOCK_C)[None, :]
    m = row_ok & (cols < w3)
    px = cols // 3
    ch = cols - px * 3
    inbox = row_in & (px >= x1) & (px < x2)
    off = (b * H + rows) * w3 + cols
    v = tl.load(img_ptr + off, mask=m & (inbox == 0), other=0.0)
    pv = tl.load(img_ptr + pimg_off + rows * w3 + cols, mask=m & inbox, other=0.0)
    v = tl.where(inbox, pv, v)
    mean = tl.where(ch == 0, m0, tl.where(ch == 1, m1, m2))
    std = tl.where(ch == 0, s0, tl.where(ch == 1, s1, s2))
    tl.store(out_img_ptr + off, ((v - mean) / std).to(out_img_ptr.dtype.element_ty), mask=m)

    # Labels and confidence: (ROWS, BLOCK_W).
    xs = tl.arange(0, BLOCK_W)[None, :]
    mw = row_ok & (xs < W)
    inbox_w = row_in & (xs >= x1) & (xs < x2)
    offw = (b * H + rows) * W + xs
    prow = rows * W + xs
    lab = tl.where(inbox_w,
                   tl.load(lab_ptr + plab_off + prow, mask=mw & inbox_w, other=0),
                   tl.load(lab_ptr + offw, mask=mw & (inbox_w == 0), other=0))
    tl.store(out_lab_ptr + offw, lab, mask=mw)
    conf = tl.where(inbox_w,
                    tl.load(conf_ptr + pconf_off + prow, mask=mw & inbox_w, other=0),
                    tl.load(conf_ptr + offw, mask=mw & (inbox_w == 0), other=0))
    tl.store(out_conf_ptr + offw, conf, mask=mw)


def _kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _KERNEL = triton.jit(_cutmix_normalize_kernel)
    return _KERNEL


def cutmix_normalize_plain(images01, labels, conf, boxes, mean: Sequence[float],
                           std: Sequence[float], out_dtype=torch.bfloat16, partner=None):
    """The kernel's specification: ``augment.cutmix_batch`` then
    ``augment.normalize_images``."""
    mixed, lab, cf = augment.cutmix_batch(images01, labels, conf, boxes, partner)
    return augment.normalize_images(mixed, mean, std, out_dtype), lab, cf


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _elements_from(base: torch.Tensor, t: torch.Tensor) -> int:
    """``t``'s start as an element offset from ``base``'s (same dtype; any
    sign): the kernel reads the partner row through ``base``'s pointer.

    This needs what CUDA gives on a 64-bit host: both tensors on the same
    device, in one flat (unified virtual) address space, so the difference
    of two allocations' addresses is itself an address offset; the kernel
    adds it in 64 bits (it is promoted against an int64 row offset), and
    ``t`` starts on a whole element of ``base``'s dtype."""
    delta = t.data_ptr() - base.data_ptr()
    assert delta % base.element_size() == 0, "the partner row is not element-aligned"
    return delta // base.element_size()


def cutmix_normalize_triton(images01, labels, conf, boxes, mean: Sequence[float],
                            std: Sequence[float], out_dtype=torch.bfloat16, partner=None):
    """Kernel A on CUDA tensors: images (B,H,W,3) f32, labels (B,H,W) i32,
    conf (B,H,W) bool, boxes (B,4) i32, ``partner`` row 0's partner (image
    (H,W,3) f32, label (H,W) i32, conf (H,W) bool; default: the batch's
    last row) -> (images in out_dtype, i32, bool)."""
    b, h, w, c = images01.shape
    dev = images01.device
    if partner is None:
        partner = (images01[-1], labels[-1], conf[-1])
    pimg, plab, pconf = partner
    ok = (
        images01.is_cuda and c == 3 and images01.dtype == torch.float32
        and images01.is_contiguous()
        and labels.dtype == torch.int32 and labels.is_contiguous()
        and conf.dtype == torch.bool and conf.is_contiguous()
        and boxes.dtype == torch.int32 and boxes.is_contiguous()
        and tuple(labels.shape) == (b, h, w) and tuple(conf.shape) == (b, h, w)
        and tuple(boxes.shape) == (b, 4)
        and pimg.dtype == torch.float32 and tuple(pimg.shape) == (h, w, 3)
        and plab.dtype == torch.int32 and tuple(plab.shape) == (h, w)
        and pconf.dtype == torch.bool and tuple(pconf.shape) == (h, w)
        and all(t.is_contiguous() for t in (pimg, plab, pconf))
        and all(t.device == dev for t in (labels, conf, boxes, pimg, plab, pconf))
        and b * h * w * 3 < 2 ** 31
    )
    if not ok:
        raise ValueError(
            "cutmix_normalize kernel takes contiguous CUDA tensors: images f32 "
            "(B,H,W,3), labels i32 (B,H,W), conf bool (B,H,W), boxes i32 (B,4) and a "
            "partner row of each; got "
            f"{images01.dtype}{tuple(images01.shape)}, {labels.dtype}{tuple(labels.shape)}, "
            f"{conf.dtype}{tuple(conf.shape)}, {boxes.dtype}{tuple(boxes.shape)}, partner "
            f"{[(t.dtype, tuple(t.shape)) for t in partner]}"
        )
    kern = _kernel()
    out_img = torch.empty((b, h, w, 3), dtype=out_dtype, device=dev)
    out_lab = torch.empty_like(labels)
    out_conf = torch.empty_like(conf)
    grid = (b, (h + ROWS - 1) // ROWS)
    kern[grid](
        images01, labels, conf.view(torch.uint8), boxes, out_img, out_lab,
        out_conf.view(torch.uint8), _elements_from(images01, pimg), _elements_from(labels, plab),
        _elements_from(conf, pconf), h, w,
        float(mean[0]), float(mean[1]), float(mean[2]),
        float(std[0]), float(std[1]), float(std[2]),
        ROWS=ROWS, BLOCK_C=_next_pow2(3 * w), BLOCK_W=_next_pow2(w), num_warps=4,
    )
    cutmix_normalize_triton.launches += 1
    return out_img, out_lab, out_conf


cutmix_normalize_triton.launches = 0


def cutmix_normalize(images01, labels, conf, boxes, mean: Sequence[float],
                     std: Sequence[float], out_dtype=torch.bfloat16, partner=None):
    """CUDA -> kernel A (raises on what it does not take), CPU -> plain.
    ``partner``: row 0's partner (image, label, conf); by default the
    batch's own last row."""
    if images01.is_cuda:
        return cutmix_normalize_triton(images01, labels, conf, boxes, mean, std, out_dtype,
                                       partner)
    if images01.device.type != "cpu":
        raise ValueError(f"cutmix_normalize: unsupported device {images01.device}")
    return cutmix_normalize_plain(images01, labels, conf, boxes, mean, std, out_dtype, partner)
