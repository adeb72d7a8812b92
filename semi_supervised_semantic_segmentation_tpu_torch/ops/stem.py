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
kernels are tested against.  Beside them stand plain versions of the
kernels' operand layout (``pack_stem_weights``, ``stem_fwd_windowed``,
``stem_dw_windowed``, built on the pure indexing functions
``window_geometry`` and ``window_start``), which the CPU
tests hold against the specification; nothing on the card's path calls
them.  See ``csrc/stem.cu`` for the design and what bounds it on the card.

Counters: ``stem_fwd_cuda.launches`` / ``stem_dw_cuda.launches`` count every
launch, ``.launches_vec`` those on the 16-byte copy path (``stem_vec``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.ops import cuda_build

SOURCE = "stem.cu"
CO = 64
# The kernels' tiles (csrc/stem.cu): TW output pixels by 2 output rows (B)
# or 1 (C).
TW = 128
TILE_ROWS = {"fwd": 2, "dw": 1}
# Left margin, in input columns, of a staged row: element 0 of a tile's row
# is column 2*ox0 - LEFT, channel 0.
LEFT = 8
PLAN_KEYS = ("threads", "tile_pixels", "stages", "fwd_tile_rows", "fwd_smem", "fwd_blocks_per_sm",
             "fwd_k_width", "dw_tile_rows", "dw_smem", "dw_blocks_per_sm", "dw_n_width")


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
# The kernels' operand layout, in plain torch (tested on the CPU)
# ---------------------------------------------------------------------------


def window_geometry(k: int) -> Tuple[int, int, int]:
    """(KW, s, W0) of the kernels' K layout at kernel size k.  The 3k (kw, c)
    taps of a kernel row are 3k consecutive elements of a staged NHWC row;
    the kernels read them as a KW-wide window that starts s = p % 2
    elements early (p = (k-1)/2), at element W0 + 6j for output pixel j of
    the tile, so that every window starts at an even element (32-bit
    aligned pairs).  KW = 8 * ceil((3k + s) / 8): one m16n8k16 step per 16
    window positions (B; the 8-wide tails of two rows share one)."""
    p = (k - 1) // 2
    s = p % 2
    return 8 * ((3 * k + s + 7) // 8), s, 3 * (LEFT - p) - s


def window_start(j: int, k: int) -> int:
    """Element of a staged row where the window of output pixel j (counted
    from the tile's first pixel) begins."""
    return 6 * j + window_geometry(k)[2]


def pack_stem_weights(w_hwio: torch.Tensor) -> torch.Tensor:
    """w HWIO [k,k,3,64] f32 -> B's packed bf16 weights [64, k*KW]: column
    kh*KW + s + 3*kw + c holds bf16(w[kh,kw,c,:]); every other column
    (the window's pad positions) is exactly 0."""
    k = w_hwio.shape[0]
    kwid, s, _ = window_geometry(k)
    out = torch.zeros((w_hwio.shape[-1], k, kwid), dtype=torch.bfloat16, device=w_hwio.device)
    out[:, :, s:s + 3 * k] = w_hwio.reshape(k, 3 * k, -1).permute(2, 0, 1).to(torch.bfloat16)
    return out.reshape(w_hwio.shape[-1], k * kwid)


def _staged_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """x NHWC -> [N, H + 2p, 3 * (W + 2*LEFT)] f32: every input row the
    kernels stage, flattened NHWC, zero outside the image; element 0 is
    column -LEFT (a tile at ox0 = 0 stages exactly these columns)."""
    p = (k - 1) // 2
    xp = F.pad(x.float(), (0, 0, LEFT, LEFT, p, p))
    return xp.reshape(xp.shape[0], xp.shape[1], -1)


def _windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """[N, H/2, W/2, k*KW] f32: slot kh*KW + pos of output pixel (oy, ox) is
    staged element window_start(ox) + pos of input row 2*oy - p + kh."""
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    kwid, _, w0 = window_geometry(k)
    rows = _staged_rows(x, k)
    win = rows[..., w0:].unfold(-1, kwid, 6)[:, :, :w2]  # [N, rows, W2, KW]
    return torch.cat([win[:, kh:kh + 2 * h2:2] for kh in range(k)], dim=-1)


def stem_fwd_windowed(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's arithmetic in plain torch: y[co, pixel] = sum over the
    k*KW window slots of pack_stem_weights(w)[co, slot] times the pixel's
    window element, in f32, rounded once.  x NHWC, w OIHW -> (y NCHW,
    [2,64] f32 stats)."""
    k = w.shape[-1]
    n, h, wd, _ = x.shape
    wp = pack_stem_weights(w.detach().permute(2, 3, 1, 0)).float()
    y = (_windows(x, k) @ wp.t()).reshape(n, h // 2, wd // 2, -1)
    y = y.permute(0, 3, 1, 2).contiguous().to(x.dtype)
    y32 = y.float()
    return y, torch.stack([y32.sum(dim=(0, 2, 3)), (y32 * y32).sum(dim=(0, 2, 3))])


def stem_dw_windowed(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor, ds: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Kernel C's arithmetic in plain torch: dW[slot, co] = sum over pixels
    of dY[co, pixel] times the pixel's window element at the slot, in f32,
    over B's k*KW window slots; then the pad slots are dropped and the rest
    unpacked to HWIO.  -> dW OIHW [64,3,k,k]."""
    kwid, s, _ = window_geometry(k)
    dyr = fold_stats_cotangent(dy, y, ds).float()
    slots = torch.einsum("nchw,nhwm->mc", dyr, _windows(x, k))  # [k*KW, 64]
    dw = slots.reshape(k, kwid, -1)[:, s:s + 3 * k]  # [kh][3*kw + c][co]
    return dw.reshape(k, k, 3, -1).permute(3, 2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.stem_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.stem_fwd.restype = i
        lib.stem_dw.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.stem_dw.restype = i
        lib.stem_plan.argtypes = [i, vp]
        lib.stem_plan.restype = i
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


def stem_vec(shape, ptrs) -> bool:
    """The kernels' copy path, decided before the launch from x's shape
    [N,H,W,3] and the tensors' addresses alone: 16-byte cp.async copies of
    the input rows (and of dy, y) and 16-byte y stores need W % 16 == 0 and
    every pointer 16-byte aligned; anything else takes the synchronous
    element-wise fill and scalar stores of the same kernels."""
    return shape[2] % 16 == 0 and all(p % 16 == 0 for p in ptrs)


_PLANS: Dict[Tuple[int, int], dict] = {}


def stem_plan(k: int, device=None) -> dict:
    """The kernels' plan at kernel size k, from the source: threads, tile,
    ring stages, shared bytes and blocks per SM of B and C (the occupancy
    calculator's, registers included), B's K width, C's padded taps."""
    index = None if device is None else torch.device(device).index
    dev = torch.cuda.current_device() if index is None else index
    key = (dev, k)
    if key not in _PLANS:
        out = (ctypes.c_int * len(PLAN_KEYS))()
        with torch.cuda.device(dev):
            _raise_on(_lib().stem_plan(k, out), "stem_plan")
        _PLANS[key] = dict(zip(PLAN_KEYS, out))
    return _PLANS[key]


def _grid(device: torch.device, k: int, which: str, n: int, h: int, w: int) -> int:
    """Persistent grid: as many blocks as fit on the card, at most one per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ntiles = n * -(-(h // 2) // TILE_ROWS[which]) * -(-(w // 2) // TW)
    per_sm = max(1, stem_plan(k, device)[f"{which}_blocks_per_sm"])
    return max(1, min(ntiles, per_sm * sms))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def stem_fwd_cuda(x: torch.Tensor, w_hwio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B: x NHWC bf16, w HWIO f32 -> (y NCHW bf16, [2,64] f32)."""
    n, h, wd, k = _check_x(x, w_hwio)
    lib = _lib()
    y = torch.empty((n, CO, h // 2, wd // 2), dtype=torch.bfloat16, device=x.device)
    sums = torch.empty((2, CO), dtype=torch.float32, device=x.device)
    grid = _grid(x.device, k, "fwd", n, h, wd)
    partial = torch.empty((grid, 2, CO), dtype=torch.float32, device=x.device)
    vec = stem_vec(x.shape, (x.data_ptr(), y.data_ptr()))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.stem_fwd(x.data_ptr(), w_hwio.data_ptr(), y.data_ptr(), partial.data_ptr(),
                       sums.data_ptr(), n, h, wd, k, grid, int(vec), stream)
    _raise_on(err, "stem_fwd")
    stem_fwd_cuda.launches += 1
    stem_fwd_cuda.launches_vec += int(vec)
    return y, sums


stem_fwd_cuda.launches = 0
stem_fwd_cuda.launches_vec = 0


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
    grid = _grid(x.device, k, "dw", n, h, wd)
    partial = torch.empty((grid, 3 * k * k, CO), dtype=torch.float32, device=x.device)
    vec = stem_vec(x.shape, (x.data_ptr(), dy.data_ptr(), y.data_ptr()))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.stem_dw(x.data_ptr(), dy.data_ptr(), y.data_ptr(), ds.data_ptr(),
                      partial.data_ptr(), dw.data_ptr(), n, h, wd, k, grid, int(vec), stream)
    _raise_on(err, "stem_dw")
    stem_dw_cuda.launches += 1
    stem_dw_cuda.launches_vec += int(vec)
    return dw


stem_dw_cuda.launches = 0
stem_dw_cuda.launches_vec = 0


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
    """(x, w) -> (y, stats); backward = kernel C, no gradient for x.

    Under ``torch.func.vmap`` (CPS's ``stacked`` form: w carries a leading
    net axis) the :meth:`vmap` rule runs the function once per slice of
    that axis, so the card launches B, and in the backward C, once per
    net."""

    @staticmethod
    def forward(x, w):
        return stem_fwd(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w = inputs
        ctx.save_for_backward(x, output[0])
        ctx.k = w.shape[-1]

    @staticmethod
    def backward(ctx, dy, ds):
        x, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        if ds is None:
            ds = torch.zeros((2, y.shape[1]), dtype=torch.float32, device=y.device)
        return None, stem_dw(x, dy, y, ds, ctx.k)

    @staticmethod
    def vmap(info, in_dims, x, w):
        xd, wd = in_dims
        outs = [StemConvBN.apply(x if xd is None else x.select(xd, i),
                                 w if wd is None else w.select(wd, i))
                for i in range(info.batch_size)]
        return (torch.stack([y for y, _ in outs]), torch.stack([s for _, s in outs])), (0, 0)


def stem_conv_bn(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable stem: x NHWC [N,H,W,3], w OIHW [64,3,k,k] f32 ->
    (y NCHW in x's dtype, [2,64] f32 (sum, sum of squares) of y)."""
    return StemConvBN.apply(x, w)
