"""HRNet branch-chain 3x3 conv with fused BatchNorm: kernels D and E.

Replaces ``semi_supervised_semantic_segmentation_tpu/ops/pallas_conv.py``
(``_conv3x3_nchw_impl`` -- kernel D -- and ``_conv3x3_dw_impl`` -- kernel E;
public as ``conv3x3_nchw`` and ``conv3x3_bn_nchw``).  Contract, with x NCHW
[N,C,H,W] in bf16 and the weight OIHW [C,C,3,3] f32 (cast to bf16):

- D (``conv3x3_fwd``): stride-1 SAME 3x3 conv.  With (mul, add) the conv
  input is t = relu(bf16(bf16(x * bf16(mul)) + bf16(add))) -- the previous
  layer's folded BatchNorm and ReLU, rounded as the reference's kernel
  rounds it -- and SAME padding pads t with zeros.  f32 accumulation, one
  rounding of y; the optional [2,C] f32 statistics are the per-channel
  (sum, sum of squares) of the ROUNDED y.  ``flip`` convolves with the
  tap-flipped, in/out-swapped weights (the dx conv).
- D's post mode (``conv3x3_dx_post``, the reference's ``post``): the dx
  conv dt = conv(dY, flipped w) of a conv whose input was t = relu(x*mul +
  add), with :func:`pre_backward` fused after it: dtm = dt where
  bf16(bf16(x * bf16(mul)) + bf16(add)) > 0, else 0; dx = bf16(dtm * mul)
  with the raw f32 mul; (dmul, dadd) = (sum dtm * x, sum dtm) per channel,
  as one [2,C] f32.  dt never reaches memory.
- E (``conv3x3_dw``): with the statistics cotangent ds, the total output
  cotangent dY = bf16((dy + ds[0]) + (2*y)*ds[1]) composed in f32 (also
  returned, for the dx conv); dk = sum over pixels of dY (x) shifted t in
  f32, OIHW.

The backward of the op with the input transform always takes D's post
mode.  The reference takes it only under ``SSTPU_CBR_DX_FUSE=1`` and runs
D's dx conv followed by :func:`pre_backward` otherwise; the two give the
same dx bits and (dmul, dadd) that differ only in the order of f32 sums,
so the port reads no such variable.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/branch_conv.cu`` (bf16, C <= 128, H % 8 == 0; anything else raises).
E stages its tiles through an asynchronous ring where the shape and the
pointers allow it (:func:`dw_async`) and fills them synchronously
otherwise, in the same kernel.  D has three kernels, picked before the
launch by :func:`fwd_kernel`, where W % 8 == 0 and the activations are
16-byte aligned: at channels padded to 96 (C = 81..96) D96
(``conv_fwd96_kernel``: one block per SM, 4 x 32-pixel tiles of all 96
output channels, x staged once per tile through E's ``cp.async`` copies and
transform, the weights packed once per call into a bf16 scratch and
streamed per tap); at channels padded to 48 (C = 33..48) D48
(``conv_fwd48_kernel``: one block per SM, 8 x 32-pixel tiles of all 48
output channels, the packed weights resident in shared memory, x staged two
tiles ahead); else ``conv_fwd_kernel``.  Counters:
``conv3x3_dw_cuda.launches_async`` (E's ring launches),
``conv3x3_fwd_cuda.launches_post`` (D's post-mode launches),
``launches_c96`` / ``launches_c48`` (D96's / D48's launches, every mode)
and ``launches_c96_post`` / ``launches_c48_post`` (their post-mode
launches); each D launch is also counted in ``conv3x3_fwd_cuda.launches``.
On a CPU tensor they run the plain versions below, which the kernels are
tested against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.ops import cuda_build
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from semi_supervised_semantic_segmentation_tpu_torch.ops.stem import fold_stats_cotangent

SOURCE = "branch_conv.cu"
MAX_C = 128
C96 = 96  # the padded channel width D96 serves
C48 = 48  # the padded channel width D48 serves
BH = 32  # the reference's row window: eligibility needs H % BH == 0


def supported(shape, c_in: int, c_out: int) -> bool:
    """Eligibility of x [N, C, H, W] for the kernels (the reference's gate)."""
    _, _, h, _ = shape
    return c_in == c_out and c_in <= MAX_C and h % BH == 0 and h >= BH


# ---------------------------------------------------------------------------
# Plain versions (the kernels' specification)
# ---------------------------------------------------------------------------


def transform_input(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """relu(bf16(bf16(x * mul_r) + add_r)) with mul_r, add_r rounded to x's dtype."""
    mul_r = mul.to(x.dtype).float()[None, :, None, None]
    add_r = add.to(x.dtype).float()[None, :, None, None]
    t = ((x.float() * mul_r).to(x.dtype).float() + add_r).to(x.dtype)
    return torch.clamp_min(t, 0)


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW weights of the dx conv: taps flipped, in and out swapped."""
    return w.flip(2, 3).transpose(0, 1)


def conv3x3_fwd_plain(x, w, mul=None, add=None, stats: bool = True, flip: bool = False):
    """-> (y in x's dtype, [2,C] f32 stats or None)."""
    t = x if mul is None else transform_input(x, mul, add)
    wf = (flip_weight(w) if flip else w).to(x.dtype).float()
    y = F.conv2d(t.float(), wf, padding=1).to(x.dtype)
    if not stats:
        return y, None
    y32 = y.float()
    return y, torch.stack([y32.sum(dim=(0, 2, 3)), (y32 * y32).sum(dim=(0, 2, 3))])


def conv3x3_dw_plain(x, dy, y=None, ds=None, mul=None, add=None):
    """-> (dk OIHW f32, dY in x's dtype or None).  With (y, ds) the stats
    cotangent is folded into dY first."""
    dY = fold_stats_cotangent(dy, y, ds) if y is not None else dy.to(x.dtype)
    t = x if mul is None else transform_input(x, mul, add)
    c = x.shape[1]
    dk = torch.nn.grad.conv2d_weight(t.float(), (dY.shape[1], c, 3, 3), dY.float(), padding=1)
    return dk, (dY if y is not None else None)


def pre_backward(x, dt, mul, add):
    """Chain dt (the gradient of t = relu(x*mul + add)) back to x, mul and
    add, as the reference's XLA code after its dx kernel: the mask is the
    same bf16 fma the kernels apply, strictly > 0 (the ReLU gradient is 0 at
    0); dx = bf16(dtm * mul) with the raw f32 mul."""
    mul_r = mul.to(x.dtype).float()[None, :, None, None]
    add_r = add.to(x.dtype).float()[None, :, None, None]
    pre = ((x.float() * mul_r).to(x.dtype).float() + add_r).to(x.dtype)
    dtm = torch.where(pre > 0, dt.float(), torch.zeros((), device=dt.device))
    dx = (dtm * mul.float()[None, :, None, None]).to(x.dtype)
    return dx, (dtm * x.float()).sum(dim=(0, 2, 3)), dtm.sum(dim=(0, 2, 3))


def _padded(c: int) -> int:
    return (c + 15) // 16 * 16


def pack_weights_plain(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """D96's and D48's packed weights: [9, Cp, Cp + 8] bf16 with Cp = C
    padded to 16, tap-major, rows C_out, with wp[kh*3 + kw, co, ci] =
    bf16(w'[co, ci, kh, kw]) for w' = w or :func:`flip_weight` (w); 0 for co
    or ci >= C and in the 8-column skew."""
    c = w.shape[0]
    cp = _padded(c)
    wf = (flip_weight(w) if flip else w).to(torch.bfloat16)
    out = torch.zeros((9, cp, cp + 8), dtype=torch.bfloat16, device=w.device)
    out[:, :c, :c] = wf.permute(2, 3, 0, 1).reshape(9, c, c)
    return out


def conv3x3_dx_post_plain(dY, w, x, mul, add):
    """D's post mode: the dx conv of dY followed by :func:`pre_backward`.
    -> (dx in x's dtype, [2,C] f32 (dmul, dadd))."""
    dt = conv3x3_fwd_plain(dY, w, stats=False, flip=True)[0]
    dx, dmul, dadd = pre_backward(x, dt, mul, add)
    return dx, torch.stack([dmul, dadd])


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.branch_conv_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_plan.restype = i
        lib.branch_conv_fwd.argtypes = [vp] * 8 + [i] * 9 + [vp]
        lib.branch_conv_fwd.restype = i
        lib.branch_conv_dx_post.argtypes = [vp] * 9 + [i] * 6 + [vp]
        lib.branch_conv_dx_post.restype = i
        lib.branch_conv_fwd96_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_fwd96_plan.restype = i
        lib.branch_conv_fwd48_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_fwd48_plan.restype = i
        lib.branch_conv_pack.argtypes = [vp, vp, i, i, vp]
        lib.branch_conv_pack.restype = i
        lib.branch_conv_dw_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_dw_plan.restype = i
        lib.branch_conv_dw.argtypes = [vp] * 9 + [i] * 8 + [vp]
        lib.branch_conv_dw.restype = i
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _plan_values(entry: str, n: int, c: int, h: int, w: int) -> Tuple[int, ...]:
    """The n ints the kernel source's plan entry writes for C, H, W: a pure
    function of them for the built library, so asked once per shape."""
    out = (ctypes.c_int * n)()
    _raise_on(getattr(_lib(), entry)(c, h, w, out), entry)
    return tuple(out)


def _plan_dict(keys, entry: str, c: int, h: int, w: int) -> dict:
    return dict(zip(keys, _plan_values(entry, len(keys), c, h, w)))


def _plan(c: int, h: int, w: int) -> Tuple[int, int, int, int, int, int]:
    """(D's shared bytes, D's C_out split, E's shared bytes, E's row
    split, D's tiles per image, D's shared bytes in post mode) from the
    kernel source's own geometry."""
    return _plan_values("branch_conv_plan", 6, c, h, w)


DW_PLAN_KEYS = ("smem", "row_blocks", "rows", "tile_rows", "stages", "tiles")


def dw_plan(c: int, h: int, w: int) -> dict:
    """E's tile plan for C channels at H x W, from the kernel source: shared
    bytes, blocks per slab (the split of dk's rows), dk rows per block, tile
    rows, ring stages, tiles per image."""
    return _plan_dict(DW_PLAN_KEYS, "branch_conv_dw_plan", c, h, w)


def dw_async(shape, ptrs) -> bool:
    """E's staging path, decided before the launch from x's shape [N,C,H,W]
    and the tensors' addresses alone: the asynchronous ring copies whole
    16-byte chunks of rows, so it needs W % 8 == 0 and every pointer 16-byte
    aligned; anything else takes the synchronous fill."""
    return shape[3] % 8 == 0 and all(p % 16 == 0 for p in ptrs)


FWD96_PLAN_KEYS = ("smem", "x_stages", "w_stages", "tile_rows", "tiles", "wpack")


def fwd96_plan(c: int, h: int, w: int) -> dict:
    """D96's plan for C channels (padded to 96) at H x W, from the kernel
    source: shared bytes, x stages, weight stages, tile rows, tiles per
    image, packed weight elements."""
    return _plan_dict(FWD96_PLAN_KEYS, "branch_conv_fwd96_plan", c, h, w)


FWD48_PLAN_KEYS = ("smem", "x_stages", "tile_rows", "blocks_per_sm", "tiles", "wpack")


def fwd48_plan(c: int, h: int, w: int) -> dict:
    """D48's plan for C channels (padded to 48) at H x W, from the kernel
    source: shared bytes, x stages, tile rows, blocks per SM (the occupancy
    calculator's), tiles per image, packed weight elements."""
    return _plan_dict(FWD48_PLAN_KEYS, "branch_conv_fwd48_plan", c, h, w)


def _packed_ok(shape, ptrs, cp: int) -> bool:
    # the copies of D96 and D48 take whole 16-byte chunks of rows, as E's ring
    return _padded(shape[1]) == cp and dw_async(shape, ptrs)


def fwd_c96(shape, ptrs) -> bool:
    """D96 for x's shape [N,C,H,W] and the activations' addresses: channels
    that pad to 96, W % 8 == 0 and every pointer 16-byte aligned."""
    return _packed_ok(shape, ptrs, C96)


def fwd_c48(shape, ptrs) -> bool:
    """D48 for x's shape [N,C,H,W] and the activations' addresses: channels
    that pad to 48, W % 8 == 0 and every pointer 16-byte aligned."""
    return _packed_ok(shape, ptrs, C48)


def fwd_kernel(shape, ptrs) -> int:
    """D's kernel, decided before the launch from the shape and the
    addresses alone: 96 (D96), 48 (D48) or 0 (``conv_fwd_kernel``, for
    anything else)."""
    return C96 if fwd_c96(shape, ptrs) else C48 if fwd_c48(shape, ptrs) else 0


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"branch conv kernel: {msg}")


def _check_act(name: str, t: torch.Tensor, shape=None) -> None:
    _check(t.is_cuda and t.dtype == torch.bfloat16 and t.is_contiguous() and t.dim() == 4,
           f"{name} must be a contiguous CUDA bf16 NCHW tensor, got {t.dtype} {tuple(t.shape)} "
           f"on {t.device}")
    if shape is not None:
        _check(tuple(t.shape) == tuple(shape), f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _check_vec(name: str, t: torch.Tensor, shape, device) -> None:
    _check(t.dtype == torch.float32 and t.is_contiguous() and tuple(t.shape) == tuple(shape)
           and t.device == device, f"{name} must be contiguous f32 {tuple(shape)} on {device}")


def _geometry(x: torch.Tensor, w: torch.Tensor):
    _check_act("x", x)
    n, c, h, wd = x.shape
    _check(c <= MAX_C and h % 8 == 0, f"needs C <= {MAX_C} and H % 8 == 0, got C={c} H={h}")
    _check_vec("w", w, (c, c, 3, 3), x.device)
    return n, c, h, wd


def _slabs(device: torch.device, per_sm: int, split: int, tiles: int) -> int:
    """Persistent blocks per C_out/column split: as many as run on the card
    at once (``per_sm`` blocks on each SM), never more than tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, per_sm * sms // split))


def _fwd_slabs(device: torch.device, smem: int, split: int, tiles: int) -> int:
    # D: 2 blocks per SM where the shared memory allows (C <= 48)
    return _slabs(device, 2 if 2 * smem <= 227 * 1024 else 1, split, tiles)


def conv3x3_fwd_cuda(x: torch.Tensor, w: torch.Tensor, mul=None, add=None, stats: bool = True,
                     flip: bool = False):
    """Kernel D: x bf16 NCHW, w f32 OIHW -> (y bf16, [2,C] f32 or None)."""
    n, c, h, wd = _geometry(x, w)
    if mul is not None:
        _check_vec("mul", mul, (c,), x.device)
        _check_vec("add", add, (c,), x.device)
    y = torch.empty_like(x)
    kern = fwd_kernel(x.shape, (x.data_ptr(), y.data_ptr()))
    nslab, wpack = _fwd_launch_plan(x.device, n, c, h, wd, kern)
    sums = partial = None
    if stats:
        sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
        partial = torch.empty((nslab, 2, c), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().branch_conv_fwd(x.data_ptr(), w.data_ptr(), ptr(mul), ptr(add), y.data_ptr(),
                                 ptr(partial), ptr(sums), ptr(wpack), n, c, h, wd,
                                 int(mul is not None), int(stats), int(flip), nslab, kern,
                                 stream)
    _raise_on(err, "branch_conv_fwd")
    _count(kern, post=False)
    return y, sums


conv3x3_fwd_cuda.launches = 0
conv3x3_fwd_cuda.launches_post = 0
conv3x3_fwd_cuda.launches_c96 = 0
conv3x3_fwd_cuda.launches_c96_post = 0
conv3x3_fwd_cuda.launches_c48 = 0
conv3x3_fwd_cuda.launches_c48_post = 0


def _count(kern: int, post: bool) -> None:
    """One launch of D by the kernel ``kern`` (:func:`fwd_kernel`)."""
    f = conv3x3_fwd_cuda
    f.launches += 1
    f.launches_post += int(post)
    f.launches_c96 += int(kern == C96)
    f.launches_c96_post += int(kern == C96 and post)
    f.launches_c48 += int(kern == C48)
    f.launches_c48_post += int(kern == C48 and post)


def _fwd_launch_plan(device, n: int, c: int, h: int, wd: int, kern: int, post: bool = False):
    """(persistent blocks, the packed-weight scratch of D96 or D48 or None)
    for D's kernel ``kern`` at [n, c, h, wd]."""
    if kern:
        plan = (fwd96_plan if kern == C96 else fwd48_plan)(c, h, wd)
        wpack = torch.empty(plan["wpack"], dtype=torch.bfloat16, device=device)
        per_sm = plan["blocks_per_sm"] if kern == C48 else 1
        return _slabs(device, per_sm, 1, n * plan["tiles"]), wpack
    smem, nmt, _, _, tiles, smem_post = _plan(c, h, wd)
    return _fwd_slabs(device, smem_post if post else smem, nmt, n * tiles), None


def pack_weights_cuda(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The weight pack of D96 or D48 alone (the kernel each of their
    launches runs first): w f32 OIHW on the card, C padding to 96 or 48 ->
    [9, Cp, Cp + 8] bf16 (:func:`pack_weights_plain`)."""
    c = w.shape[0]
    cp = _padded(c)
    _check_vec("w", w, (c, c, 3, 3), w.device)
    _check(w.is_cuda and cp in (C96, C48), f"needs a CUDA w with C padding to {C96} or {C48}")
    out = torch.empty((9, cp, cp + 8), dtype=torch.bfloat16, device=w.device)
    err = _lib().branch_conv_pack(w.data_ptr(), out.data_ptr(), c, int(flip),
                                  torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on(err, "branch_conv_pack")
    return out


def conv3x3_dx_post_cuda(dY: torch.Tensor, w: torch.Tensor, x: torch.Tensor, mul: torch.Tensor,
                         add: torch.Tensor):
    """Kernel D's post mode: dY, x bf16 NCHW, w f32 OIHW (the forward conv's),
    mul, add f32 [C] (raw) -> (dx bf16, [2,C] f32 (dmul, dadd))."""
    n, c, h, wd = _geometry(dY, w)
    _check_act("x", x, dY.shape)
    _check_vec("mul", mul, (c,), dY.device)
    _check_vec("add", add, (c,), dY.device)
    dx = torch.empty_like(dY)
    kern = fwd_kernel(dY.shape, (dY.data_ptr(), dx.data_ptr(), x.data_ptr()))
    nslab, wpack = _fwd_launch_plan(dY.device, n, c, h, wd, kern, post=True)
    sums = torch.empty((2, c), dtype=torch.float32, device=dY.device)
    partial = torch.empty((nslab, 2, c), dtype=torch.float32, device=dY.device)
    stream = torch.cuda.current_stream(dY.device).cuda_stream
    err = _lib().branch_conv_dx_post(dY.data_ptr(), w.data_ptr(), x.data_ptr(), mul.data_ptr(),
                                     add.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                                     sums.data_ptr(), None if wpack is None else wpack.data_ptr(),
                                     n, c, h, wd, nslab, kern, stream)
    _raise_on(err, "branch_conv_dx_post")
    _count(kern, post=True)
    return dx, sums


def conv3x3_dw_cuda(x: torch.Tensor, dy: torch.Tensor, y=None, ds=None, mul=None, add=None):
    """Kernel E: -> (dk f32 OIHW [C,C,3,3], dY bf16 or None)."""
    dk = torch.empty((x.shape[1], x.shape[1], 3, 3), dtype=torch.float32, device=x.device)
    n, c, h, wd = _geometry(x, dk)
    _check_act("dy", dy, x.shape)
    fuse = y is not None
    if fuse:
        _check_act("y", y, x.shape)
        _check_vec("ds", ds, (2, c), x.device)
    if mul is not None:
        _check_vec("mul", mul, (c,), x.device)
        _check_vec("add", add, (c,), x.device)
    plan = dw_plan(c, h, wd)
    cp = _padded(c)
    # E: one block per SM (its f32 partial fills the registers)
    nslab = _slabs(x.device, 1, plan["row_blocks"], n * plan["tiles"])
    partial = torch.empty((nslab, cp, 9 * cp), dtype=torch.float32, device=x.device)
    dY = torch.empty_like(x) if fuse else None
    ring = dw_async(x.shape, [t.data_ptr() for t in (x, dy, y, dY) if t is not None])
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().branch_conv_dw(x.data_ptr(), dy.data_ptr(), ptr(y), ptr(ds), ptr(mul), ptr(add),
                                ptr(dY), partial.data_ptr(), dk.data_ptr(), n, c, h, wd,
                                int(mul is not None), int(fuse), nslab, int(ring), stream)
    _raise_on(err, "branch_conv_dw")
    conv3x3_dw_cuda.launches += 1
    conv3x3_dw_cuda.launches_async += int(ring)
    return dk, dY


conv3x3_dw_cuda.launches = 0
conv3x3_dw_cuda.launches_async = 0


# ---------------------------------------------------------------------------
# Dispatching wrappers + autograd
# ---------------------------------------------------------------------------


def _on_cpu(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"branch conv: unsupported device {x.device}")
    return True


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().float().contiguous()


def conv3x3_fwd(x, w, mul=None, add=None, stats: bool = True, flip: bool = False):
    """Kernel D on CUDA tensors, the plain version on CPU tensors."""
    if _on_cpu(x):
        return conv3x3_fwd_plain(x, w, mul, add, stats, flip)
    return conv3x3_fwd_cuda(x.contiguous(), _f32(w), _f32(mul), _f32(add), stats, flip)


def conv3x3_dx_post(dY, w, x, mul, add):
    """Kernel D's post mode on CUDA tensors, the plain version on CPU tensors."""
    if _on_cpu(dY):
        return conv3x3_dx_post_plain(dY, w, x, mul, add)
    return conv3x3_dx_post_cuda(dY.contiguous(), _f32(w), x.contiguous(), _f32(mul), _f32(add))


def conv3x3_dw(x, dy, y=None, ds=None, mul=None, add=None):
    """Kernel E on CUDA tensors, the plain version on CPU tensors."""
    if _on_cpu(x):
        return conv3x3_dw_plain(x, dy, y, ds, mul, add)
    return conv3x3_dw_cuda(x.contiguous(), dy.to(x.dtype).contiguous(), y, _f32(ds), _f32(mul),
                           _f32(add))


def _cotangents(dy, ds, y):
    if dy is None:
        dy = torch.zeros_like(y)
    if ds is None:
        ds = torch.zeros((2, y.shape[1]), dtype=torch.float32, device=y.device)
    return dy, ds


class _Conv(torch.autograd.Function):
    """(x, w) -> y.  Backward: E for dk, D with the flipped weights for dx."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w, stats=False)[0]

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dk = conv3x3_dw(x, dy)[0]
        dx = conv3x3_fwd(dy, w, stats=False, flip=True)[0] if ctx.needs_input_grad[0] else None
        return dx, dk


class _ConvBN(torch.autograd.Function):
    """(x, w) -> (y, s).  Backward: E with the stats cotangent folded gives
    (dk, dY), then D on dY with the flipped weights gives dx."""

    @staticmethod
    def forward(ctx, x, w):
        y, s = conv3x3_fwd(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        x, w, y = ctx.saved_tensors
        dy, ds = _cotangents(dy, ds, y)
        dk, dY = conv3x3_dw(x, dy, y, ds)
        dx = conv3x3_fwd(dY, w, stats=False, flip=True)[0] if ctx.needs_input_grad[0] else None
        return dx, dk


class _ConvBNPre(torch.autograd.Function):
    """(x, w, mul, add) -> (y, s) with the input transform inside the
    kernels.  Backward: E with the stats cotangent and the transform gives
    (dk, dY); then D's post mode gives dx and (dmul, dadd) in one launch."""

    @staticmethod
    def forward(ctx, x, w, mul, add):
        y, s = conv3x3_fwd(x, w, mul, add)
        ctx.save_for_backward(x, w, mul, add, y)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        x, w, mul, add, y = ctx.saved_tensors
        dy, ds = _cotangents(dy, ds, y)
        dk, dY = conv3x3_dw(x, dy, y, ds, mul, add)
        dx, dsum = conv3x3_dx_post(dY, w, x, mul, add)
        return dx, dk, dsum[0], dsum[1]


def conv3x3_nchw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 conv of x [N,C,H,W] (compute dtype) with w OIHW f32
    cast to x's dtype; differentiable in both."""
    return _Conv.apply(x, w)


def conv3x3_bn_nchw(x: torch.Tensor, w: torch.Tensor, mul: Optional[torch.Tensor] = None,
                    add: Optional[torch.Tensor] = None,
                    mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused branch-chain conv: y = conv3x3(t, w) with t = relu(x*mul + add)
    when (mul, add) (f32 [C], the previous folded BatchNorm) are given, else
    t = x.  Returns (y, [2,C] f32 (sum, sum of squares) of y): the next
    BatchNorm's batch statistics.  Differentiable in x, w, mul and add.

    ``mesh`` (data parallelism; the counterpart of the reference's
    ``shard_map`` form): x is this rank's rows; D runs on them and one
    ``all_reduce`` of the [2,C] sums gives every rank the global statistics.
    The backward hands E the global stats cotangent (that collective's
    adjoint), which it folds into this rank's dY; dk, and (dmul, dadd) from
    D's post mode, stay this rank's: the gradient sum over ranks adds them
    once (a second sum here would count them R times)."""
    if mul is None:
        y, s = _ConvBN.apply(x, w)
    else:
        y, s = _ConvBNPre.apply(x, w, mul, add)
    return y, all_reduce_sum(s, mesh)
