"""Stem conv with fused BatchNorm statistics: kernels B (forward) and C (dW).

Replaces ``semi_supervised_semantic_segmentation_tpu/ops/pallas_stem.py``
(``_stem_fwd``/``_fwd_kernel`` and ``_stem_dw``/``_dw_kernel``, public as
``stem_conv_bn_s2``).  Contract:

- forward: x NHWC [N,H,W,3] (data, no gradient), w OIHW [64,3,k,k] f32
  (cast to the compute dtype) -> y NCHW [N,64,H/2,W/2] in x's dtype, plus
  [2,64] f32 (sum y, sum y^2) of the rounded y: the next BatchNorm's batch
  statistics.  A stride-2 SAME conv with torch's (k-1)/2 padding, f32
  accumulation, one rounding.
- backward: the stats cotangent folds into the output cotangent,
  dY = dy + ds[0] + 2*y*ds[1], composed in f32 and rounded to x's dtype
  before the dW contraction; dW is f32; x gets no gradient.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/stem.cu`` (bf16, Cin 3, Co 64, odd k <= 11, even H and W; anything
else raises).  On a CPU tensor they run the plain versions below, which the
kernels are tested against.  See ``csrc/stem.cu`` for the design and what
bounds it on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.ops import cuda_build

SOURCE = "stem.cu"
CO = 64
# Persistent grid: blocks per SM for the two kernels.
BLOCKS_PER_SM = 2


# ---------------------------------------------------------------------------
# Plain versions (the kernels' specification)
# ---------------------------------------------------------------------------


def stem_fwd_plain(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x NHWC, w OIHW f32 -> (y NCHW in x.dtype, [2,Co] f32 stats)."""
    k = w.shape[-1]
    xf = x.permute(0, 3, 1, 2).float()
    wf = w.to(x.dtype).float()
    y = F.conv2d(xf, wf, stride=2, padding=(k - 1) // 2).to(x.dtype)
    y32 = y.float()
    return y, torch.stack([y32.sum(dim=(0, 2, 3)), (y32 * y32).sum(dim=(0, 2, 3))])


def fold_stats_cotangent(dy: torch.Tensor, y: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """dY = dy + ds[0] + 2*y*ds[1] in f32, rounded to y's dtype."""
    ds = ds.float()
    return (dy.float() + ds[0][None, :, None, None]
            + 2.0 * y.float() * ds[1][None, :, None, None]).to(y.dtype)


def stem_dw_plain(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor, ds: torch.Tensor,
                  k: int) -> torch.Tensor:
    """-> dW OIHW [Co,3,k,k] f32 with the stats cotangent folded in."""
    dyr = fold_stats_cotangent(dy, y, ds).float()
    xf = x.permute(0, 3, 1, 2).float()
    return torch.nn.grad.conv2d_weight(xf, (dy.shape[1], x.shape[-1], k, k), dyr,
                                       stride=2, padding=(k - 1) // 2)


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.stem_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.stem_fwd.restype = i
        lib.stem_dw.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.stem_dw.restype = i
        lib._typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"stem kernel: {msg}")


def _check_x(x: torch.Tensor, w_hwio: torch.Tensor):
    _check(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous(),
           f"x must be a contiguous CUDA bf16 NHWC tensor, got {x.dtype} on {x.device}")
    _check(x.dim() == 4 and x.shape[-1] == 3, f"x must be [N,H,W,3], got {tuple(x.shape)}")
    n, h, wd, _ = x.shape
    _check(h % 2 == 0 and wd % 2 == 0, f"H and W must be even, got {h}x{wd}")
    k = w_hwio.shape[0]
    _check(w_hwio.dtype == torch.float32 and w_hwio.is_contiguous() and w_hwio.device == x.device
           and tuple(w_hwio.shape) == (k, k, 3, CO) and k % 2 == 1 and k <= 11,
           f"w must be f32 HWIO [k,k,3,{CO}] with odd k <= 11 on {x.device}, "
           f"got {tuple(w_hwio.shape)} {w_hwio.dtype}")
    return n, h, wd, k


def _grid(device: torch.device, ntiles: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(ntiles, BLOCKS_PER_SM * sms))


def _ntiles(n: int, h: int, w: int) -> int:
    return n * (h // 2) * ((w // 2 + 63) // 64)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def stem_fwd_cuda(x: torch.Tensor, w_hwio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: x NHWC bf16, w HWIO f32 -> (y NCHW bf16, [2,64] f32)."""
    n, h, wd, k = _check_x(x, w_hwio)
    lib = _lib()
    y = torch.empty((n, CO, h // 2, wd // 2), dtype=torch.bfloat16, device=x.device)
    sums = torch.empty((2, CO), dtype=torch.float32, device=x.device)
    grid = _grid(x.device, _ntiles(n, h, wd))
    partial = torch.empty((grid, 2, CO), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.stem_fwd(x.data_ptr(), w_hwio.data_ptr(), y.data_ptr(), partial.data_ptr(),
                       sums.data_ptr(), n, h, wd, k, grid, stream)
    _raise_on(err, "stem_fwd")
    stem_fwd_cuda.launches += 1
    return y, sums


stem_fwd_cuda.launches = 0


def stem_dw_cuda(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor, ds: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Kernel C: -> dW HWIO [k,k,3,64] f32."""
    dw = torch.empty((k, k, 3, CO), dtype=torch.float32, device=x.device)
    n, h, wd, _ = _check_x(x, dw)
    yshape = (n, CO, h // 2, wd // 2)
    for name, t in (("dy", dy), ("y", y)):
        _check(t.dtype == torch.bfloat16 and t.is_contiguous() and tuple(t.shape) == yshape
               and t.device == x.device, f"{name} must be contiguous bf16 {yshape}")
    _check(ds.dtype == torch.float32 and ds.is_contiguous() and tuple(ds.shape) == (2, CO)
           and ds.device == x.device, "ds must be contiguous f32 [2,64]")
    lib = _lib()
    grid = _grid(x.device, _ntiles(n, h, wd))
    partial = torch.empty((grid, 3 * k * k, CO), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.stem_dw(x.data_ptr(), dy.data_ptr(), y.data_ptr(), ds.data_ptr(),
                      partial.data_ptr(), dw.data_ptr(), n, h, wd, k, grid, stream)
    _raise_on(err, "stem_dw")
    stem_dw_cuda.launches += 1
    return dw


stem_dw_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatching wrappers + autograd
# ---------------------------------------------------------------------------


def stem_fwd(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x NHWC, w OIHW -> (y NCHW, stats).  CUDA -> kernel B, CPU -> plain."""
    if x.is_cuda:
        return stem_fwd_cuda(x.contiguous(), w.detach().permute(2, 3, 1, 0).contiguous().float())
    if x.device.type != "cpu":
        raise ValueError(f"stem: unsupported device {x.device}")
    return stem_fwd_plain(x, w)


def stem_dw(x, dy, y, ds, k: int) -> torch.Tensor:
    """-> dW OIHW f32.  CUDA -> kernel C, CPU -> plain."""
    if x.is_cuda:
        return stem_dw_cuda(x.contiguous(), dy.contiguous(), y, ds.float().contiguous(),
                            k).permute(3, 2, 0, 1).contiguous()
    if x.device.type != "cpu":
        raise ValueError(f"stem: unsupported device {x.device}")
    return stem_dw_plain(x, dy, y, ds, k)


class StemConvBN(torch.autograd.Function):
    """(x, w) -> (y, stats); backward = kernel C, no gradient for x."""

    @staticmethod
    def forward(ctx, x, w):
        y, sums = stem_fwd(x, w)
        ctx.save_for_backward(x, y)
        ctx.k = w.shape[-1]
        return y, sums

    @staticmethod
    def backward(ctx, dy, ds):
        x, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        if ds is None:
            ds = torch.zeros((2, y.shape[1]), dtype=torch.float32, device=y.device)
        return None, stem_dw(x, dy, y, ds, ctx.k)


def stem_conv_bn(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable stem: x NHWC [N,H,W,3], w OIHW [64,3,k,k] f32 ->
    (y NCHW in x's dtype, [2,64] f32 (sum, sum of squares) of y)."""
    return StemConvBN.apply(x, w)
