"""Spatial (H-axis) sharding of activations over the model axis (counterpart
of the reference's ``parallel/spatial.py``), on NCHW tensors.

Under ``parallel.model_parallel: M > 1`` each of the M model ranks of a
data rank holds a contiguous block of H / M rows (model rank m the rows
``[m H/M, (m+1) H/M)``, the reference's ``P("data", "model")``), and a conv
that reads across the block boundary pulls the rows it needs from its
neighbours first:

- :func:`halo_exchange_h`: ``halo`` rows from each neighbour (the first
  rank's top and the last rank's bottom halo are zeros, the global zero
  padding), then :func:`spatial_conv2d_same` is the global SAME conv;
- :func:`halo_pull_prev_h`: ``rows`` rows from the previous rank only
  (zeros on rank 0), then :func:`spatial_conv2d_stride2` is the global
  3 x k stride-2 conv with padding 1, HRNet's two stem convs: with an even
  local H, output row o of a block reads local rows 2o-1 .. 2o+1;
- :func:`gather_h`: every block in model order, the re-replication before
  HRNet's ``layer1`` (the reference's ``with_sharding_constraint`` to
  ``P("data", None)``); :func:`shard_h` cuts a whole tensor to this rank's
  rows.

The reference moves rows with ``lax.ppermute``.  Gloo takes CUDA tensors
only in ``all_reduce`` and ``broadcast``, so every exchange here is one
``all_reduce`` over the model group of a zero byte buffer in which each
rank fills its own slot (``parallel.mesh.gather_rows``): exact, and one
code path for gloo and NCCL.  Each halo function is an autograd function
whose backward sends the halo's cotangent back to the rank its rows came
from, the same way, and adds it to that rank's boundary rows.  The
backward of :func:`gather_h` takes this rank's rows of the cotangent and
sums nothing: the consumer is replicated over the model axis, so each
model rank's cotangent is already the whole one.

With a model axis of one rank (or no mesh) the halo functions pad with
zeros and launch nothing.  ``COUNTS`` counts the halo and gather launches
and their bytes apart (each is also one of ``parallel.mesh.COUNTS``'s
collectives).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu_torch.parallel import mesh as mesh_lib
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import Mesh

COUNTS = {"halo": 0, "halo_bytes": 0, "gather_h": 0, "gather_h_bytes": 0}


def _axis(mesh: Optional[Mesh]) -> Mesh:
    """The model axis of ``mesh`` as a one-axis mesh (one rank for None)."""
    axis = Mesh({"data": 1, "model": 1}) if mesh is None else mesh.model
    if axis.size > 1 and axis.group is None:
        raise ValueError(f"a model axis of {axis.size} ranks needs its process group")
    return axis


def _exchange(slots: List[torch.Tensor], axis: Mesh, kind: str) -> List[torch.Tensor]:
    """Every model rank's ``slots``, each as [M, *shape], bit for bit."""
    before = mesh_lib.COUNTS["bytes"]
    out = mesh_lib.gather_rows(slots, axis)
    COUNTS[kind] += 1
    COUNTS[f"{kind}_bytes"] += mesh_lib.COUNTS["bytes"] - before
    return out


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo: int, axis: Mesh):
        ctx.halo, ctx.axis = halo, axis
        tops, bottoms = _exchange([x[:, :, :halo], x[:, :, -halo:]], axis, "halo")
        m, n = axis.rank, axis.size
        zero = torch.zeros_like(x[:, :, :halo])
        above = bottoms[m - 1] if m > 0 else zero
        below = tops[m + 1] if m + 1 < n else zero
        return torch.cat([above, x, below], 2)

    @staticmethod
    def backward(ctx, g):
        halo, axis = ctx.halo, ctx.axis
        m, n = axis.rank, axis.size
        # rank i's top-halo cotangent belongs to rank i-1's last rows, its
        # bottom-halo cotangent to rank i+1's first rows
        g_tops, g_bottoms = _exchange([g[:, :, :halo], g[:, :, -halo:]], axis, "halo")
        dx = g[:, :, halo:-halo].clone()
        if m + 1 < n:
            dx[:, :, -halo:] += g_tops[m + 1]
        if m > 0:
            dx[:, :, :halo] += g_bottoms[m - 1]
        return dx, None, None


class _HaloPullPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows: int, axis: Mesh):
        ctx.rows, ctx.axis = rows, axis
        (lasts,) = _exchange([x[:, :, -rows:]], axis, "halo")
        m = axis.rank
        above = lasts[m - 1] if m > 0 else torch.zeros_like(x[:, :, -rows:])
        return torch.cat([above, x], 2)

    @staticmethod
    def backward(ctx, g):
        rows, axis = ctx.rows, ctx.axis
        m = axis.rank
        # rank i's halo cotangent belongs to rank i-1's last rows
        (g_halos,) = _exchange([g[:, :, :rows]], axis, "halo")
        dx = g[:, :, rows:].clone()
        if m + 1 < axis.size:
            dx[:, :, -rows:] += g_halos[m + 1]
        return dx, None, None


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Mesh):
        ctx.axis, ctx.h = axis, x.shape[2]
        (blocks,) = _exchange([x], axis, "gather_h")
        return torch.cat(blocks.unbind(0), 2)

    @staticmethod
    def backward(ctx, g):
        m, h = ctx.axis.rank, ctx.h
        return g[:, :, m * h:(m + 1) * h], None


def _check_halo(x: torch.Tensor, rows: int) -> None:
    if not 0 < rows <= x.shape[2]:
        raise ValueError(f"a halo of {rows} rows needs 1 .. {x.shape[2]} local rows")


def halo_exchange_h(x: torch.Tensor, halo: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """x [N, C, H_local, W] -> [N, C, H_local + 2 halo, W]: ``halo`` rows of
    the previous model rank above, of the next one below; the first rank's
    top and the last rank's bottom halo are zeros (the global SAME conv's
    zero padding).  Differentiable."""
    _check_halo(x, halo)
    axis = _axis(mesh)
    if axis.size == 1:
        return F.pad(x, (0, 0, halo, halo))
    return _HaloExchange.apply(x, halo, axis)


def halo_pull_prev_h(x: torch.Tensor, rows: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """x [N, C, H_local, W] -> [N, C, rows + H_local, W]: the previous model
    rank's last ``rows`` rows above x (zeros on rank 0, the global top zero
    padding).  Differentiable."""
    _check_halo(x, rows)
    axis = _axis(mesh)
    if axis.size == 1:
        return F.pad(x, (0, 0, rows, 0))
    return _HaloPullPrev.apply(x, rows, axis)


def spatial_conv2d_same(x: torch.Tensor, w: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Stride-1 SAME conv (odd kh, kw; w OIHW) of an H-sharded x: this
    rank's rows of the global conv."""
    kh, kw = w.shape[2], w.shape[3]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"spatial SAME conv expects odd taps, got {kh}x{kw}")
    xp = halo_exchange_h(x, kh // 2, mesh) if kh > 1 else x
    return F.conv2d(xp, w, padding=(0, kw // 2))


def spatial_conv2d_stride2(x: torch.Tensor, w: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """3 x kw stride-2 conv with padding (1, (kw - 1) / 2) (w OIHW) of an
    H-sharded x: this rank's rows of the global conv.  One top halo row from
    the previous rank; the local H must be even."""
    kh, kw = w.shape[2], w.shape[3]
    if kh != 3:
        raise ValueError(f"stride-2 spatial conv expects kh=3, got {kh}")
    if x.shape[2] % 2 != 0:
        raise ValueError(f"local H must be even for stride-2 spatial conv, got {x.shape[2]}")
    xp = halo_pull_prev_h(x, 1, mesh)
    return F.conv2d(xp, w, stride=2, padding=(0, (kw - 1) // 2))


def gather_h(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x [N, C, H_local, W] of every model rank -> [N, C, M H_local, W] in
    model order, bit for bit.  The backward is this rank's rows of the
    cotangent (its consumer is replicated over the model axis).  ``x``
    itself with a model axis of one rank."""
    axis = _axis(mesh)
    if axis.size == 1:
        return x
    return _GatherH.apply(x, axis)


def shard_h(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This model rank's block of the H rows of a whole x [N, C, H, W]; H
    must divide by the model axis's size."""
    axis = _axis(mesh)
    h = x.shape[2]
    if h % axis.size:
        raise ValueError(f"H = {h} does not divide over {axis.size} model ranks")
    step = h // axis.size
    return x[:, :, axis.rank * step:(axis.rank + 1) * step]
