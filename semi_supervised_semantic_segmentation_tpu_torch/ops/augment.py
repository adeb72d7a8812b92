"""On-device augmentation of the FixMatch step (NHWC float images in [0,1]).

Counterpart of the reference's ``ops/augment.py``.  The two frameworks'
random streams cannot match (threefry there, Philox here), so every
transform is split in two: a sampler that draws its parameters from an
explicit ``torch.Generator`` (``sample_*``), and a deterministic core that
takes them (scale, crop offsets, flip, jitter factors, op order, sigma,
CutMix box).  Tests drive the cores with the same parameters on both sides.

- weak: random scale-crop-flip as one static-shape two-tap bilinear gather,
  equal to resize(align_corners=False) -> pad(right/bottom) -> crop -> flip,
  returning the geometric content mask;
- strong: ColorJitter with a random op order (torchvision semantics),
  grayscale, Gaussian blur (reflect padding, banded-matrix form);
- CutMix: one box per sample, mixed with the roll-by-1 partner; image,
  pseudo-label and confidence share the box.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

_GRAY_WEIGHTS = (0.2989, 0.587, 0.114)


# ---------------------------------------------------------------------------
# Color-space helpers (torchvision functional-tensor semantics)
# ---------------------------------------------------------------------------


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 1) luminance with torchvision's weights."""
    w = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=img.device)
    return (img * w).sum(dim=-1, keepdim=True)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    cr_div = torch.where(eqc, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    zero = torch.zeros_like(maxc)
    hr = torch.where(maxc == r, bc - gc, zero)
    hg = torch.where((maxc == g) & (maxc != r), 2.0 + rc - bc, zero)
    hb = torch.where((maxc != g) & (maxc != r), 4.0 + gc - rc, zero)
    h = torch.remainder((hr + hg + hb) / 6.0 + 1.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = torch.remainder(i.to(torch.int32), 6)
    p = torch.clamp(v * (1.0 - s), 0.0, 1.0)
    q = torch.clamp(v * (1.0 - s * f), 0.0, 1.0)
    t = torch.clamp(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)

    def pick(a):
        out = a[0]
        for k in range(1, 6):
            out = torch.where(i == k, a[k], out)
        return out

    return torch.stack(
        [pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]), pick([p, p, t, v, v, q])],
        dim=-1,
    )


def _per_sample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> broadcastable against a (B, ...) tensor; scalars pass."""
    if not torch.is_tensor(x) or x.dim() == 0:
        return x
    return x.reshape(x.shape[0], *([1] * (like.dim() - 1)))


def _blend(img1, img2, ratio):
    """torchvision _blend: clamp(ratio*img1 + (1-ratio)*img2, 0, 1)."""
    ratio = _per_sample(ratio, img1)
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def adjust_brightness(img, factor):
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img, factor):
    """Blend with the per-sample mean of the grayscale image ((B,H,W,3))."""
    mean = rgb_to_grayscale(img).mean(dim=(-3, -2, -1), keepdim=True)
    return _blend(img, mean, factor)


def adjust_saturation(img, factor):
    return _blend(img, rgb_to_grayscale(img), factor)


def adjust_hue(img, delta):
    hsv = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    delta = _per_sample(delta, hsv[..., 0])
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


_JITTER_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter(images: torch.Tensor, factors: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """ColorJitter on a (B,H,W,3) batch: sample b applies op ``perm[b, j]``
    at position j with its factor ``factors[b, op]`` (ops: brightness,
    contrast, saturation, hue).  Every op runs on the whole batch at each
    position and a per-sample select keeps the chosen one, so no host sync
    is needed for the data-dependent order."""
    out = images
    for pos in range(4):
        nxt = out
        for k, op in enumerate(_JITTER_OPS):
            sel = _per_sample(perm[:, pos] == k, out)
            nxt = torch.where(sel, op(out, factors[:, k]), nxt)
        out = nxt
    return out


def _blur_band(sigma: torch.Tensor, size: int, kernel_size: int) -> torch.Tensor:
    """(B, size+2r, size) banded matrix: entry [b,p,q] is sample b's
    normalized Gaussian tap at offset p-q-r (zero outside the band)."""
    r = kernel_size // 2
    dev = sigma.device
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    inv2s2 = 1.0 / (2.0 * sigma.float() ** 2)
    norm = torch.exp(-(t ** 2) * inv2s2[:, None]).sum(dim=1)
    p = torch.arange(size + 2 * r, dtype=torch.float32, device=dev)[:, None]
    q = torch.arange(size, dtype=torch.float32, device=dev)[None, :]
    d = p - q - r
    band = torch.exp(-(d ** 2)[None] * inv2s2[:, None, None])
    band = torch.where((d.abs() <= r)[None], band, torch.zeros_like(band))
    return band / norm[:, None, None]


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Separable Gaussian blur of (B,H,W,C) with per-sample sigma, reflect
    padding; each axis pass is one batched float32 matmul with a banded
    matrix, as in the reference."""
    b, h, w, c = img.shape
    r = kernel_size // 2
    x = img.float().permute(0, 3, 1, 2)  # (B,C,H,W)
    xp = torch.nn.functional.pad(x, (r, r, 0, 0), mode="reflect")
    y = torch.matmul(xp, _blur_band(sigma, w, kernel_size)[:, None])  # (B,C,H,W)
    yp = torch.nn.functional.pad(y, (0, 0, r, r), mode="reflect")
    out = torch.matmul(yp.transpose(2, 3), _blur_band(sigma, h, kernel_size)[:, None])
    return out.permute(0, 3, 2, 1).contiguous().to(img.dtype)  # (B,C,W,H) -> (B,H,W,C)


def blur_kernel_size(crop_size: int) -> int:
    """~10% of the crop, forced odd, >= 3."""
    return max(int(0.1 * crop_size) // 2 * 2 + 1, 3)


@dataclass
class StrongParams:
    factors: torch.Tensor  # (B,4) f32: brightness, contrast, saturation, hue delta
    perm: torch.Tensor  # (B,4) int64: op order
    apply_jitter: torch.Tensor  # (B,) bool
    apply_gray: torch.Tensor  # (B,) bool
    sigma: torch.Tensor  # (B,) f32
    apply_blur: torch.Tensor  # (B,) bool


def sample_strong_params(g: torch.Generator, batch: int, device, *,
                         jitter_prob=0.8, brightness=0.5, contrast=0.5,
                         saturation=0.5, hue=0.25, grayscale_prob=0.2,
                         blur_prob=0.5) -> StrongParams:
    """Draw the strong-aug parameters: factors U(max(0,1-s), 1+s), hue
    U(-hue, hue), a uniform op permutation, sigma U(0.1, 2)."""
    u = torch.rand(batch, 8, generator=g, device=device)
    cols = []
    for j, s in enumerate((brightness, contrast, saturation)):
        lo, hi = max(0.0, 1.0 - s), 1.0 + s
        cols.append(lo + (hi - lo) * u[:, j])
    cols.append(-hue + 2.0 * hue * u[:, 3])
    perm = torch.argsort(torch.rand(batch, 4, generator=g, device=device), dim=1)
    return StrongParams(
        factors=torch.stack(cols, dim=1),
        perm=perm,
        apply_jitter=u[:, 4] < jitter_prob,
        apply_gray=u[:, 5] < grayscale_prob,
        sigma=0.1 + 1.9 * u[:, 6],
        apply_blur=u[:, 7] < blur_prob,
    )


def strong_augment_batch(images: torch.Tensor, p: StrongParams, blur_kernel: int) -> torch.Tensor:
    """RandomApply(ColorJitter) -> RandomGrayscale -> RandomApply(blur) on
    (B,H,W,3) in [0,1]; geometry is shared with the weak view."""
    out = torch.where(_per_sample(p.apply_jitter, images),
                      color_jitter(images, p.factors, p.perm), images)
    gray = rgb_to_grayscale(out).expand_as(out)
    out = torch.where(_per_sample(p.apply_gray, out), gray, out)
    blurred = gaussian_blur(out, p.sigma, blur_kernel)
    return torch.where(_per_sample(p.apply_blur, out), blurred, out)


# ---------------------------------------------------------------------------
# Weak geometric augmentation: fused random scale-crop-flip
# ---------------------------------------------------------------------------


@dataclass
class WeakParams:
    scale: torch.Tensor  # (B,) f32
    oy: torch.Tensor  # (B,) f32, integer-valued crop offset in the scaled frame
    ox: torch.Tensor
    flip: torch.Tensor  # (B,) bool


def _scaled_hw(sizes: torch.Tensor, scale: torch.Tensor):
    h = sizes[:, 0].float()
    w = sizes[:, 1].float()
    sh = torch.clamp(torch.round(h * scale), min=1.0)
    sw = torch.clamp(torch.round(w * scale), min=1.0)
    return h, w, sh, sw


def sample_weak_params(g: torch.Generator, sizes: torch.Tensor, crop_size: int, *,
                       scale_min=0.5, scale_max=2.0, hflip_prob=0.5) -> WeakParams:
    """scale U(min, max); integer crop offsets uniform over the valid
    range of the scaled frame (0 when it is smaller than the crop)."""
    u = torch.rand(sizes.shape[0], 4, generator=g, device=sizes.device)
    s = scale_min + (scale_max - scale_min) * u[:, 0]
    _, _, sh, sw = _scaled_hw(sizes, s)
    oy = torch.floor(u[:, 1] * (torch.clamp(sh - crop_size, min=0.0) + 1.0))
    ox = torch.floor(u[:, 2] * (torch.clamp(sw - crop_size, min=0.0) + 1.0))
    return WeakParams(scale=s, oy=oy, ox=ox, flip=u[:, 3] < hflip_prob)


def _src_taps(coords, limit):
    """Torch-style clamped bilinear taps for source coords (B, crop)."""
    src = torch.clamp(coords, min=0.0)
    i0 = torch.minimum(torch.floor(src), limit - 1).long()
    i1 = torch.minimum(i0 + 1, (limit - 1).long())
    frac = torch.clamp(src - i0.float(), 0.0, 1.0)
    return i0, i1, frac


def scale_crop_flip(images_u8: torch.Tensor, labels: torch.Tensor, sizes: torch.Tensor,
                    p: WeakParams, *, crop_size: int,
                    fill_rgb: Tuple[float, float, float], ignore_index: int):
    """Deterministic weak-aug core over a batch of uint8 canvases
    (B,Hc,Wc,3) -> ((B,c,c,3) f32 in [0,1], (B,c,c) int32 labels,
    (B,c,c) bool content mask)."""
    b, hc, wc, _ = images_u8.shape
    c = crop_size
    h, w, sh, sw = _scaled_hw(sizes, p.scale)
    h, w, sh, sw = h[:, None], w[:, None], sh[:, None], sw[:, None]
    grid = torch.arange(c, dtype=torch.float32, device=images_u8.device)[None]
    ys = (grid + p.oy[:, None] + 0.5) * (h / sh) - 0.5
    xs = (grid + p.ox[:, None] + 0.5) * (w / sw) - 0.5
    valid = ((grid + p.oy[:, None]) < sh)[:, :, None] & ((grid + p.ox[:, None]) < sw)[:, None, :]
    y0, y1, wy = _src_taps(ys, h)
    x0, x1, wx = _src_taps(xs, w)

    imgf = images_u8.float() * (1.0 / 255.0)
    rows_idx = lambda i: i[:, :, None, None].expand(b, c, wc, 3)
    top = imgf.gather(1, rows_idx(y0))
    bot = imgf.gather(1, rows_idx(y1))
    rows = top * (1.0 - wy)[:, :, None, None] + bot * wy[:, :, None, None]
    cols_idx = lambda i: i[:, None, :, None].expand(b, c, c, 3)
    left = rows.gather(2, cols_idx(x0))
    right = rows.gather(2, cols_idx(x1))
    out = left * (1.0 - wx)[:, None, :, None] + right * wx[:, None, :, None]
    fill = torch.tensor(fill_rgb, dtype=torch.float32, device=out.device)
    out = torch.where(valid[..., None], out, fill)

    ly = torch.clamp(torch.floor(ys + 0.5), min=0).minimum(h - 1).long()
    lx = torch.clamp(torch.floor(xs + 0.5), min=0).minimum(w - 1).long()
    lab = labels.gather(1, ly[:, :, None].expand(b, c, wc))
    lab = lab.gather(2, lx[:, None, :].expand(b, c, c))
    lab = torch.where(valid, lab, torch.full_like(lab, ignore_index)).to(torch.int32)

    flip = p.flip
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    lab = torch.where(flip[:, None, None], lab.flip(2), lab)
    valid = torch.where(flip[:, None, None], valid.flip(2), valid)
    return out, lab, valid


# ---------------------------------------------------------------------------
# CutMix and normalization
# ---------------------------------------------------------------------------


def cutmix_boxes(u: torch.Tensor, height: int, width: int, prob: float = 1.0) -> torch.Tensor:
    """(B,4) uniforms (lambda, centre y, centre x, apply) -> int32 (B,4)
    boxes (y1, y2, x1, x2), all zero when not applied.  The arithmetic of the reference kernel: cut =
    int(sqrt(1-lambda)*H or *W), a uniform int centre, half-cut each side,
    clipped to [0, H] and [0, W]; applied if u_apply < prob."""
    lam, ucy, ucx, uprob = u.float().unbind(1)
    ratio = torch.sqrt(1.0 - lam)
    cut_h = (ratio * height).to(torch.int32)
    cut_w = (ratio * width).to(torch.int32)
    cy = (ucy * height).to(torch.int32)
    cx = (ucx * width).to(torch.int32)
    box = torch.stack([
        torch.clamp(cy - cut_h // 2, 0, height),
        torch.clamp(cy + cut_h // 2, 0, height),
        torch.clamp(cx - cut_w // 2, 0, width),
        torch.clamp(cx + cut_w // 2, 0, width),
    ], dim=1).to(torch.int32)
    return torch.where((uprob < prob)[:, None], box, torch.zeros_like(box))


def box_mask(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B,4) int boxes -> (B,H,W) bool, True inside [y1,y2) x [x1,x2)."""
    dev = boxes.device
    yy = torch.arange(height, device=dev)[None, :, None]
    xx = torch.arange(width, device=dev)[None, None, :]
    y1, y2, x1, x2 = (boxes[:, i, None, None] for i in range(4))
    return (yy >= y1) & (yy < y2) & (xx >= x1) & (xx < x2)


def cutmix_batch(images, labels, conf, boxes):
    """Mix each sample with its roll-by-1 partner inside its box; the same
    box cuts image (B,H,W,3), labels (B,H,W) and confidence (B,H,W)."""
    m = box_mask(boxes, images.shape[1], images.shape[2])
    return (
        torch.where(m[..., None], images.roll(1, 0), images),
        torch.where(m, labels.roll(1, 0), labels),
        torch.where(m, conf.roll(1, 0), conf),
    )


def normalize_images(images01: torch.Tensor, mean, std, dtype=torch.bfloat16) -> torch.Tensor:
    """[0,1] float -> ImageNet-normalized model dtype, computed in f32."""
    m = torch.tensor(mean, dtype=torch.float32, device=images01.device)
    s = torch.tensor(std, dtype=torch.float32, device=images01.device)
    return ((images01.float() - m) / s).to(dtype)


def canvas_normalize_eval(images_u8: torch.Tensor, mean, std, dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 canvas (N,H,W,3) -> normalized ``dtype``: the eval path's feed."""
    return normalize_images(images_u8.float() * (1.0 / 255.0), mean, std, dtype)
