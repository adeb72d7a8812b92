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
E has three kernels, picked before the launch from the shape and the
pointers, where W % 8 == 0 and x, dy (and y, dY with fuse) are 16-byte
aligned: at channels padded to 96 (C = 81..96) E96 (``conv_dw96_kernel``,
:func:`dw_c96`: one cluster of 3 CTAs per slab, each owning 32 of dk's
rows, x loaded once per cluster by a TMA multicast, dy by TMA per CTA, a
2-stage ring on mbarriers fed by one producer thread); at channels padded
to 48 (C = 33..48) E48 (``conv_dw48_kernel``, :func:`dw_c48`: one
persistent CTA per SM of a producer and two consumer warpgroups on D48's
4 x 64 tiles, x, dy and y by TMA on mbarriers, x transformed into D48's
operand and dY composed in place in dy's 128-byte-swizzled box and
written out by one TMA store, the products on wgmma m64n48k16 with dY as A
from registers and the x operand as B read MN-major at each tap's offset,
:func:`dw48_operand_plan`); else
``conv_dw_kernel``, which stages its tiles through an asynchronous ring
where the shape and the pointers allow it (:func:`dw_async`) and fills
them synchronously otherwise.  A cluster launch the card refuses, or a
tensor map that fails to encode, raises; nothing gives way to another
kernel.  D has three kernels, picked before the
launch by :func:`fwd_kernel`, where W % 8 == 0 and the activations are
16-byte aligned: at channels padded to 96 (C = 81..96) D96
(``conv_d96_kernel``) and at channels padded to 48 (C = 33..48) D48
(``conv_d48_kernel``), each one persistent CTA per SM of a producer and
two consumer warpgroups on tiles of 4 rows x 64 pixels of all output
channels, wgmma (m64n96k16, m64n48k16) on shared-memory descriptors, x by
one TMA box a tile transformed into the operand whose addressing
:func:`operand_plan` gives, the weights packed once per call; D96 streams
the weights per tap through a ring and holds one x operand buffer, D48
keeps all nine weight slabs resident and double-buffers x (two boxes, two
operand buffers); stamps on request (:data:`D96_PHASES`,
:data:`D48_PHASES`); else ``conv_fwd_kernel``.  Counters:
``conv3x3_dw_cuda.launches`` (every E launch), ``launches_c96`` (E96's),
``launches_c48`` (E48's) and ``launches_async`` (``conv_dw_kernel``'s ring
alone),
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
    """The packed weights of D96 and D48 (C padding to 96 or 48), bf16,
    tap-major: [9, Cp // 8, Cp, 8], wp[kh*3 + kw, ci // 8, co, ci % 8] =
    bf16(w'[co, ci, kh, kw]) with w' = w or :func:`flip_weight` (w), 0 for co
    or ci >= C -- a tap's slab is wgmma's B operand in core matrices of 8
    C_out x 8 ci (:func:`operand_plan`)."""
    c = w.shape[0]
    cp = _padded(c)
    wf = (flip_weight(w) if flip else w).to(torch.bfloat16)
    full = torch.zeros((9, cp, cp), dtype=torch.bfloat16, device=w.device)
    full[:, :c, :c] = wf.permute(2, 3, 0, 1).reshape(9, c, c)
    return full.reshape(9, cp, cp // 8, 8).permute(0, 2, 1, 3).contiguous()


# The tile of D96 and D48: output rows, and pixels of a row (one wgmma's
# M); the x operand's halo rows are padded to an odd pitch of pixels
D96_TILE = (4, 64)
D96_ROW_PIXELS = 67


def operand_plan(cp: int) -> dict:
    """The x operand of D96 (cp = 96) or D48 (cp = 48) as its wgmma reads
    it, in bytes (the kernel takes these and checks them against its
    buffers).  The producer writes the transformed, halo'd tile of channel
    group g (8 channels), halo row r, column c at ``g * plane + r * row + c *
    16``: one 16-byte pixel vector of 8 channels, so 8 consecutive pixels
    are one core matrix (K-major, no swizzle: ``sbo`` between 8-pixel
    groups, ``lbo`` = plane between the two 8-channel halves of a k16 step).
    Tile row rr's product at tap (kh, kw) and k16 step s reads the 64 pixels
    from ``tap[kh*3 + kw] + rr * row + 2 * s * plane``: a tap is a start
    offset, no im2col and no shifted copy.  ``w_lbo`` is the same step for
    the packed weights (:func:`pack_weights_plain`: cp C_out of 16 bytes per
    channel group).  Only ``channel_groups`` and ``w_lbo`` depend on cp."""
    _check(cp in (C96, C48), f"the wgmma kernels take Cp = {C96} or {C48}, got {cp}")
    rows, cols = D96_TILE
    row = D96_ROW_PIXELS * 16
    plane = (rows + 2) * row
    tap = tuple(kh * row + kw * 16 for kh in range(3) for kw in range(3))
    return {"pixel": 16, "row": row, "plane": plane, "lbo": plane, "sbo": 128, "tap": tap,
            "channel_groups": cp // 8, "halo": (rows + 2, cols + 2), "w_lbo": cp * 16}


def d96_operand_plan() -> dict:
    """D96's x operand: :func:`operand_plan` at Cp = 96."""
    return operand_plan(C96)


def _d96_ops():
    """The kernel's int[11] of :func:`operand_plan`: plane, row, tap[9] (the
    same at both widths)."""
    p = operand_plan(C96)
    return (ctypes.c_int * 11)(p["plane"], p["row"], *p["tap"])


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
        lib.branch_conv_fwd.argtypes = [vp] * 10 + [i] * 9 + [vp]
        lib.branch_conv_fwd.restype = i
        lib.branch_conv_dx_post.argtypes = [vp] * 11 + [i] * 6 + [vp]
        lib.branch_conv_dx_post.restype = i
        lib.branch_conv_fwd96_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_fwd96_plan.restype = i
        lib.branch_conv_fwd48_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_fwd48_plan.restype = i
        lib.branch_conv_pack.argtypes = [vp, vp, i, i, vp]
        lib.branch_conv_pack.restype = i
        lib.branch_conv_dw_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_dw_plan.restype = i
        lib.branch_conv_dw.argtypes = [vp] * 11 + [i] * 9 + [vp]
        lib.branch_conv_dw96_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_dw96_plan.restype = i
        lib.branch_conv_dw48_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.branch_conv_dw48_plan.restype = i
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


# E96's stamps per CTA, in the kernel's order (csrc/branch_conv.cu,
# conv_dw96_kernel): clock64 sums of thread 0's phases (the tile loop holds
# the others) and of the producer thread's, then global-timer marks
DW96_PHASES = ("wait for a stage", "staging (transform, compose)", "block barrier", "products",
               "tile loop", "producer: wait for a release and issue", "start (global ns)",
               "loop start (global ns)", "loop end (global ns)", "partials stored (global ns)",
               "end (global ns)")

DW96_PLAN_KEYS = ("smem", "cluster", "clusters", "stages", "tile_rows", "tiles", "x_box_cols",
                  "threads")


def dw96_plan(c: int, h: int, w: int) -> dict:
    """E96's plan for C channels (padded to 96) at H x W, from the kernel
    source: shared bytes, CTAs per cluster, clusters that fit on the card
    at once (the occupancy calculator's: the grid), ring stages, tile rows,
    tiles per image, x box columns, threads per CTA."""
    return _plan_dict(DW96_PLAN_KEYS, "branch_conv_dw96_plan", c, h, w)


# E48's stamps per CTA, in the kernel's order (csrc/branch_conv.cu,
# conv_dw48_kernel): clock64 sums of the producers' thread 0, which issues
# every load after its share of the transform ("issue the next boxes" holds
# the producers' barrier, the x, dy and y boxes' issue and the wait for the
# y stage), and of the first consumer warpgroup's thread 0 (the compose
# ends at the consumers' barrier); its tile loop holds the six phases
# before the epilogue; then global-timer marks.  "issue the products" is
# the wgmma instructions' issue, which stalls while the tensor cores' queue
# is full
DW48_PHASES = ("producer: wait for the x boxes", "producer: wait for an empty operand",
               "producer: transform", "producer: issue the next boxes",
               "consumer: wait for a transformed tile", "consumer: wait for dy and y",
               "consumer: compose", "consumer: issue the products",
               "consumer: wait for the products", "consumer: release the stage",
               "consumer: epilogue", "consumer: tile loop", "start (global ns)",
               "loop start (global ns)", "loop end (global ns)", "end (global ns)")

DW48_PLAN_KEYS = ("smem", "x_stages", "x_buffers", "dy_stages", "y_stages", "tile_rows",
                  "tile_pixels", "warpgroups", "ctas_per_sm", "tiles", "x_box_cols", "taps_wg0")


def dw48_plan(c: int, h: int, w: int) -> dict:
    """E48's plan for C channels (padded to 48) at H x W, from the kernel
    source: shared bytes, raw x stages (D48's box and the left halo's side
    box), x operand buffers, dy stages (dY composed in place), y stages,
    tile rows and pixels per row, warpgroups (one producer, two consumers),
    CTAs per SM (the occupancy calculator's: 0 where the plan does not fit),
    tiles per image, x box columns, and the taps of consumer warpgroup 0
    (warpgroup 1 takes the rest)."""
    return _plan_dict(DW48_PLAN_KEYS, "branch_conv_dw48_plan", c, h, w)


def dw48_operand_plan() -> dict:
    """E48's operands as its products read them, in bytes (the kernel
    source's constants; ``tests/test_torch_dw48.py`` reads a tile through
    them).  A is dY, M = 64 C_out (rows 48-63 are zeros), K = pixels, read
    into registers by ldmatrix from the dy stage as TMA's 128-byte swizzle
    lands it: output row rr's box [48 C_out][64 px] starts at ``rr *
    a_row_box`` and C_out co's line at ``co * a_line``, whose 16-byte chunk
    q holds pixels 8 (q ^ co % 8) ..; k16 step s of the row takes pixels 16
    s .. 16 s + 15.  B is :func:`operand_plan` (48)'s x operand read by a
    wgmma descriptor MN-major (N = the 48 ci, 8 to a 16-byte pixel vector,
    ``b_sbo`` between channel groups; K = pixels, ``b_lbo`` between groups
    of 8): tap (kh, kw) of row rr and step s starts at ``tap[kh*3 + kw] + rr
    * row + s * b_kstep``.  Consumer warpgroup 0 takes taps 0 ..
    ``taps_wg0`` - 1, warpgroup 1 the rest."""
    p = operand_plan(C48)
    rows, cols = D96_TILE
    return {"a_line": cols * 2, "a_row_box": C48 * cols * 2, "a_swizzle": 128, "a_rows": 64,
            "b_lbo": 128, "b_sbo": p["plane"], "b_kstep": 16 * p["pixel"], "tap": p["tap"],
            "row": p["row"], "tile": (rows, cols), "k_steps": rows * cols // 16, "taps_wg0": 5}


def dw_async(shape, ptrs) -> bool:
    """E's staging path, decided before the launch from x's shape [N,C,H,W]
    and the tensors' addresses alone: the asynchronous ring copies whole
    16-byte chunks of rows, so it needs W % 8 == 0 and every pointer 16-byte
    aligned; anything else takes the synchronous fill."""
    return shape[3] % 8 == 0 and all(p % 16 == 0 for p in ptrs)


# the plans of D96 and D48, in the kernel source's order (wgd_plan)
FWD96_PLAN_KEYS = ("smem", "x_buffers", "w_stages", "tile_rows", "tile_pixels", "warpgroups",
                   "ctas_per_sm", "tiles", "wpack", "row_pixels", "raw_bytes")
FWD48_PLAN_KEYS = ("smem", "x_buffers", "w_slabs", "tile_rows", "tile_pixels", "warpgroups",
                   "ctas_per_sm", "tiles", "wpack", "row_pixels", "raw_bytes")


def fwd96_plan(c: int, h: int, w: int) -> dict:
    """D96's plan for C channels (padded to 96) at H x W, from the kernel
    source: shared bytes, x operand buffers, weight stages, tile rows and
    pixels per row, warpgroups (one producer, two consumers), CTAs per SM
    (the occupancy calculator's: 0 where the plan does not fit), tiles per
    image, packed weight elements, the x operand's halo row pitch, the raw
    x stage's bytes (one TMA box a tile)."""
    return _plan_dict(FWD96_PLAN_KEYS, "branch_conv_fwd96_plan", c, h, w)


# the stamps of D96 and D48 per CTA, in the kernels' order
# (csrc/branch_conv.cu, conv_d96_kernel and conv_d48_kernel): clock64 sums
# of one thread of each role, then global-timer marks.  D96: the x
# producer's lane 0 of warp 1, the weight producer's lane 0 of warp 0, the
# first consumer warpgroup's thread 0
D96_PHASES = ("x producer: wait for the raw box and the operand", "x producer: fill",
              "weights: wait for an empty slab", "consumer: wait for x",
              "consumer: wait for a slab", "consumer: products", "consumer: epilogue",
              "consumer: tile loop", "start (global ns)", "loop start (global ns)",
              "loop end (global ns)", "end (global ns)")
# D48: the producers' thread 0 (the fill ends at the producers' barrier, so
# it is the slowest producer warp's), the first consumer warpgroup's thread
# 0; its tile loop holds the weights' wait and the four phases after it.
# "issue the products" is the wgmma instructions' issue, which stalls while
# the tensor cores' queue is full: it holds most of the products' time;
# "wait for the products" is what they take beyond it
D48_PHASES = ("x producer: wait for the raw box", "x producer: wait for an empty operand",
              "x producer: fill", "consumer: wait for the weights", "consumer: wait for x",
              "consumer: issue the products", "consumer: wait for the products",
              "consumer: epilogue", "consumer: tile loop", "start (global ns)",
              "loop start (global ns)", "loop end (global ns)", "end (global ns)")


def fwd48_plan(c: int, h: int, w: int) -> dict:
    """D48's plan for C channels (padded to 48) at H x W, from the kernel
    source: shared bytes, x buffers (two raw TMA stages and two operand
    buffers), weight slabs in shared memory (all nine, resident), tile rows
    and pixels per row, warpgroups (one producer, two consumers), CTAs per
    SM (the occupancy calculator's: 0 where the plan does not fit), tiles
    per image, packed weight elements, the x operand's halo row pitch, one
    raw x stage's bytes (one TMA box a tile)."""
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


def dw_c96(shape, ptrs) -> bool:
    """E96 for x's shape [N,C,H,W] and the addresses of x, dy (and y, dY
    with fuse): channels that pad to 96, W % 8 == 0 and every pointer
    16-byte aligned -- also TMA's conditions (global strides in multiples of
    16 bytes, a 16-byte aligned base)."""
    return _packed_ok(shape, ptrs, C96)


def dw_c48(shape, ptrs) -> bool:
    """E48 for x's shape [N,C,H,W] and the addresses of x, dy (and y, dY
    with fuse): channels that pad to 48, W % 8 == 0 and every pointer
    16-byte aligned -- also TMA's conditions."""
    return _packed_ok(shape, ptrs, C48)


def fwd_kernel(shape, ptrs) -> int:
    """D's kernel, decided before the launch from the shape and the
    addresses alone: 96 (D96), 48 (D48) or 0 (``conv_fwd_kernel``, for
    anything else)."""
    return C96 if fwd_c96(shape, ptrs) else C48 if fwd_c48(shape, ptrs) else 0


TMAP_ERR = 10000  # the kernel source's code for a tensor map that failed to encode


def _raise_on(err: int, name: str) -> None:
    if err >= TMAP_ERR:
        raise RuntimeError(f"{name}: a TMA tensor map failed to encode: "
                           f"CUresult {err - TMAP_ERR}")
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stamps(device, kern: int, nslab: int, cycles: bool) -> Optional[torch.Tensor]:
    _check(not cycles or kern in (C96, C48), "stamps are D96's and D48's")
    phases = D96_PHASES if kern == C96 else D48_PHASES
    return torch.zeros((nslab, len(phases)), dtype=torch.int64,
                       device=device) if cycles else None


def conv3x3_fwd_cuda(x: torch.Tensor, w: torch.Tensor, mul=None, add=None, stats: bool = True,
                     flip: bool = False, cycles: bool = False):
    """Kernel D: x bf16 NCHW, w f32 OIHW -> (y bf16, [2,C] f32 or None);
    with ``cycles`` (D96 and D48 only) also an int64 [CTAs, 12 or 13]
    tensor of each CTA's stamps (:data:`D96_PHASES`, :data:`D48_PHASES`)."""
    n, c, h, wd = _geometry(x, w)
    if mul is not None:
        _check_vec("mul", mul, (c,), x.device)
        _check_vec("add", add, (c,), x.device)
    y = torch.empty_like(x)
    kern = fwd_kernel(x.shape, (x.data_ptr(), y.data_ptr()))
    nslab, wpack = _fwd_launch_plan(x.device, n, c, h, wd, kern)
    cyc = _stamps(x.device, kern, nslab, cycles)
    sums = partial = None
    if stats:
        sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
        partial = torch.empty((nslab, 2, c), dtype=torch.float32, device=x.device)
    ops = _d96_ops()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().branch_conv_fwd(x.data_ptr(), w.data_ptr(), _ptr(mul), _ptr(add), y.data_ptr(),
                                 _ptr(partial), _ptr(sums), _ptr(wpack), _ptr(cyc),
                                 ctypes.addressof(ops), n, c, h, wd, int(mul is not None),
                                 int(stats), int(flip), nslab, kern, stream)
    _raise_on(err, "branch_conv_fwd")
    _count(kern, post=False)
    return (y, sums, cyc) if cycles else (y, sums)


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
        _check(plan["ctas_per_sm"] > 0, f"{'D96' if kern == C96 else 'D48'}'s plan "
               f"({plan['smem']} shared bytes) does not fit on this card")
        wpack = torch.empty(plan["wpack"], dtype=torch.bfloat16, device=device)
        return _slabs(device, plan["ctas_per_sm"], 1, n * plan["tiles"]), wpack
    smem, nmt, _, _, tiles, smem_post = _plan(c, h, wd)
    return _fwd_slabs(device, smem_post if post else smem, nmt, n * tiles), None


def pack_weights_cuda(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The weight pack of D96 or D48 alone (the kernel each of their
    launches runs first): w f32 OIHW on the card, C padding to 96 or 48 ->
    :func:`pack_weights_plain`'s layout."""
    c = w.shape[0]
    cp = _padded(c)
    _check_vec("w", w, (c, c, 3, 3), w.device)
    _check(w.is_cuda and cp in (C96, C48), f"needs a CUDA w with C padding to {C96} or {C48}")
    out = torch.empty((9, cp // 8, cp, 8), dtype=torch.bfloat16, device=w.device)
    err = _lib().branch_conv_pack(w.data_ptr(), out.data_ptr(), c, int(flip),
                                  torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on(err, "branch_conv_pack")
    return out


def conv3x3_dx_post_cuda(dY: torch.Tensor, w: torch.Tensor, x: torch.Tensor, mul: torch.Tensor,
                         add: torch.Tensor, cycles: bool = False):
    """Kernel D's post mode: dY, x bf16 NCHW, w f32 OIHW (the forward conv's),
    mul, add f32 [C] (raw) -> (dx bf16, [2,C] f32 (dmul, dadd)); with
    ``cycles`` (D96 and D48 only) also the CTAs' stamps, as
    :func:`conv3x3_fwd_cuda`."""
    n, c, h, wd = _geometry(dY, w)
    _check_act("x", x, dY.shape)
    _check_vec("mul", mul, (c,), dY.device)
    _check_vec("add", add, (c,), dY.device)
    dx = torch.empty_like(dY)
    kern = fwd_kernel(dY.shape, (dY.data_ptr(), dx.data_ptr(), x.data_ptr()))
    nslab, wpack = _fwd_launch_plan(dY.device, n, c, h, wd, kern, post=True)
    cyc = _stamps(dY.device, kern, nslab, cycles)
    sums = torch.empty((2, c), dtype=torch.float32, device=dY.device)
    partial = torch.empty((nslab, 2, c), dtype=torch.float32, device=dY.device)
    ops = _d96_ops()
    stream = torch.cuda.current_stream(dY.device).cuda_stream
    err = _lib().branch_conv_dx_post(dY.data_ptr(), w.data_ptr(), x.data_ptr(), mul.data_ptr(),
                                     add.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                                     sums.data_ptr(), _ptr(wpack), _ptr(cyc),
                                     ctypes.addressof(ops), n, c, h, wd, nslab, kern, stream)
    _raise_on(err, "branch_conv_dx_post")
    _count(kern, post=True)
    return (dx, sums, cyc) if cycles else (dx, sums)


def dw_kernel(shape, ptrs) -> str:
    """E's kernel, decided before the launch from x's shape and the
    addresses of x, dy (and y): "e96", "e48", "ring" or "fill"."""
    if dw_c96(shape, ptrs):
        return "e96"
    if dw_c48(shape, ptrs):
        return "e48"
    return "ring" if dw_async(shape, ptrs) else "fill"


def conv3x3_dw_cuda(x: torch.Tensor, dy: torch.Tensor, y=None, ds=None, mul=None, add=None):
    """Kernel E: -> (dk f32 OIHW [C,C,3,3], dY bf16 or None), on E96 where
    :func:`dw_c96` holds, on E48 where :func:`dw_c48` holds, else on
    ``conv_dw_kernel``."""
    # dY, when fused, is a fresh allocation: aligned like every tensor torch makes
    ptrs = [t.data_ptr() for t in (x, dy, y) if t is not None]
    return conv3x3_dw_launch(x, dy, y, ds, mul, add, dw_kernel(x.shape, ptrs))[:2]


def conv3x3_dw_launch(x: torch.Tensor, dy: torch.Tensor, y=None, ds=None, mul=None, add=None,
                      kernel: str = "e96", cycles: bool = False):
    """Kernel E on the kernel named: "e96" (``conv_dw96_kernel``), "e48"
    (``conv_dw48_kernel``), "ring" or "fill" (``conv_dw_kernel`` through its
    asynchronous ring or its synchronous fill).  :func:`conv3x3_dw_cuda`
    names the one the shape and the pointers take; a caller naming another
    one (``chip_smoke.py`` times ``conv_dw_kernel``'s ring beside E96 and
    E48) gets it, or ValueError where it cannot take them.  -> (dk, dY or
    None, cycles or None): with ``cycles`` (E96 and E48 only) an int64
    tensor of each CTA's stamps: E96 [3 * clusters, 11]
    (:data:`DW96_PHASES`), E48 [CTAs, 16] (:data:`DW48_PHASES`)."""
    _check(kernel in ("e96", "e48", "ring", "fill"), f"unknown E kernel {kernel!r}")
    _check(not cycles or kernel in ("e96", "e48"), "stamps are E96's and E48's")
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
    cp = _padded(c)
    dY = torch.empty_like(x) if fuse else None
    ptrs = [t.data_ptr() for t in (x, dy, y, dY) if t is not None]
    if kernel == "e96":
        _check(dw_c96(x.shape, ptrs), f"E96 needs C padding to {C96}, W % 8 == 0 and 16-byte "
               f"aligned tensors, got {tuple(x.shape)}")
        plan = dw96_plan(c, h, wd)
        _check(plan["clusters"] > 0, f"no cluster of {plan['cluster']} CTAs with "
               f"{plan['smem']} shared bytes fits on this card")
        nslab = max(1, min(n * plan["tiles"], plan["clusters"]))
    elif kernel == "e48":
        _check(dw_c48(x.shape, ptrs), f"E48 needs C padding to {C48}, W % 8 == 0 and 16-byte "
               f"aligned tensors, got {tuple(x.shape)}")
        plan = dw48_plan(c, h, wd)
        _check(plan["ctas_per_sm"] > 0, f"E48's plan ({plan['smem']} shared bytes) does not fit "
               f"on this card")
        nslab = _slabs(x.device, plan["ctas_per_sm"], 1, n * plan["tiles"])
    else:
        _check(kernel == "fill" or dw_async(x.shape, ptrs),
               "E's ring needs W % 8 == 0 and 16-byte aligned tensors")
        plan = dw_plan(c, h, wd)
        # one block per SM (its f32 partial fills the registers)
        nslab = _slabs(x.device, 1, plan["row_blocks"], n * plan["tiles"])
    partial = torch.empty((nslab, cp, 9 * cp), dtype=torch.float32, device=x.device)
    cyc = None
    if cycles:
        shape = (3 * nslab, len(DW96_PHASES)) if kernel == "e96" else (nslab, len(DW48_PHASES))
        cyc = torch.zeros(shape, dtype=torch.int64, device=x.device)
    ops = _d96_ops()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().branch_conv_dw(x.data_ptr(), dy.data_ptr(), _ptr(y), _ptr(ds), _ptr(mul),
                                _ptr(add), _ptr(dY), partial.data_ptr(), dk.data_ptr(), _ptr(cyc),
                                ctypes.addressof(ops), n, c, h, wd, int(mul is not None),
                                int(fuse), nslab, int(kernel == "ring"),
                                {"e96": C96, "e48": C48}.get(kernel, 0), stream)
    _raise_on(err, "branch_conv_dw")
    f = conv3x3_dw_cuda
    f.launches += 1
    f.launches_async += int(kernel == "ring")
    f.launches_c96 += int(kernel == "e96")
    f.launches_c48 += int(kernel == "e48")
    return dk, dY, cyc


conv3x3_dw_cuda.launches = 0
conv3x3_dw_cuda.launches_async = 0
conv3x3_dw_cuda.launches_c96 = 0
conv3x3_dw_cuda.launches_c48 = 0


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
