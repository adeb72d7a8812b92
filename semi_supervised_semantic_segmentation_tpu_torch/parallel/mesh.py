"""Data parallelism on ``torch.distributed`` (counterpart of the reference's
``parallel/mesh.py``).

The reference writes its step for the global batch and lets GSPMD insert
the collectives, so every reduction over the batch or the pixels is
global.  Here each of R ranks holds a contiguous block of 1/R of the rows
of every global batch (``data/pipeline.py``'s process slices,
:func:`shard_batch`), and each global reduction is placed by hand on one
of three collectives:

- :func:`all_reduce_sum`: a differentiable sum over ranks whose backward
  sums the cotangent the same way (BatchNorm's, kernel B's and kernel D's
  ``[2, C]`` statistics; the loss normalisers' counts, with no gradient);
- :func:`gather_rows`: the rows of every rank, bit for bit, as one
  ``all_reduce`` of a zero buffer in which each rank fills its own slot
  (CutMix's partner row across the rank boundary);
- :func:`broadcast_from_rank0`: parameters and buffers, after construction
  and restore.

With ``parallel.model_parallel: M > 1`` the R = D·M processes form the
reference's ``(data, model)`` mesh, world rank ``d·M + m``
(``parallel/mesh.py:24-37`` of the reference reshapes its devices so).
Every collective above runs over the *data* axis (the D ranks that share
``m``): the M model ranks of one data rank hold the same rows and compute
the same values, so a sum over the world would count them M times.  The
model axis carries the H-sharded stem (``parallel/spatial.py``); the world
carries the stem's BatchNorm statistics, the gradient bucket, the
broadcast and the barrier (:attr:`Mesh.world`).

Only ``all_reduce`` and ``broadcast`` are used: gloo takes CUDA tensors for
those two and not for ``send``/``recv`` or ``all_gather``, so two ranks on
one card (gloo) and ranks on cards of their own (NCCL) run one code path.

With no initialized process group the mesh has one rank and no group, and
every collective is the identity and launches nothing.  Under a group of
size 1 the collectives launch and return their input unchanged.
``COUNTS`` counts the collectives launched and the bytes they reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from semi_supervised_semantic_segmentation_tpu_torch.config import (
    ParallelConfig,
    data_parallel_size,
)

COUNTS = {"collectives": 0, "bytes": 0}


@dataclasses.dataclass(eq=False)
class Mesh:
    """``shape`` {"data": D, "model": M}.  ``rank`` / ``group``: this
    process's place on the data axis and the group of the D ranks that share
    its model rank (every data-parallel collective runs over it);
    ``model_rank`` / ``model_group``: its place on the model axis and the
    group of the M ranks that share its data rank; ``world_group``: all D·M.
    A group is None where no collective launches: in one process with no
    ``torch.distributed``, and for the data axis of one rank beside a model
    axis.  Copies (``copy.deepcopy`` of a model that holds it) share the one
    mesh."""

    shape: Dict[str, int]
    rank: int = 0
    group: Optional[Any] = None
    model_rank: int = 0
    model_group: Optional[Any] = None
    world_group: Optional[Any] = None

    @property
    def size(self) -> int:
        return self.shape["data"]

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def world_rank(self) -> int:
        return self.rank * self.model_size + self.model_rank

    @property
    def world(self) -> "Mesh":
        """Every rank as one data axis, in world-rank order (the mesh itself
        without a model axis)."""
        if self.model_size == 1:
            return self
        return Mesh({"data": self.size * self.model_size, "model": 1}, self.world_rank,
                    self.world_group, world_group=self.world_group)

    @property
    def model(self) -> "Mesh":
        """The model axis as a mesh of one axis: its ``size``, ``rank`` and
        ``group`` are the model axis's."""
        return Mesh({"data": self.model_size, "model": 1}, self.model_rank, self.model_group)

    def __deepcopy__(self, memo):
        return self


def make_mesh(data_parallel: int = -1, model_parallel: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the default process group (one rank
    and no group without ``torch.distributed``).  ``data_parallel`` -1 is
    the world size over ``model_parallel``; any other value times
    ``model_parallel`` must equal the world size
    (``config.data_parallel_size``).  Under a model axis every rank creates
    every subgroup, in one order: the M data groups (ranks ``m, M + m, ...``),
    then the D model groups (ranks ``d·M .. d·M + M - 1``).  A subgroup that
    fails to form raises."""
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    d = data_parallel_size(ParallelConfig(data_parallel=data_parallel,
                                          model_parallel=model_parallel), world)
    m = model_parallel
    if not on:
        return Mesh({"data": d, "model": m})
    rank, everyone = dist.get_rank(), dist.group.WORLD
    if m == 1:
        return Mesh({"data": d, "model": 1}, rank, everyone, world_group=everyone)
    data_group, model_group = None, everyone
    if d > 1:
        data_groups = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
        model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
        data_group, model_group = data_groups[rank % m], model_groups[rank // m]
    return Mesh({"data": d, "model": m}, rank // m, data_group, rank % m, model_group, everyone)


def launches(mesh: Optional[Mesh]) -> bool:
    """True where a collective on ``mesh`` launches (a process group exists)."""
    return mesh is not None and mesh.group is not None


def size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.size


def row_block(mesh: Optional[Mesh], n: int) -> Tuple[int, slice]:
    """For ``n`` local rows: (the global row count, this rank's slice of it)."""
    r, s = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    return n * s, slice(r * n, (r + 1) * n)


def concat_rows(mesh: Optional[Mesh], *local: int) -> torch.Tensor:
    """This rank's rows of the concatenation of global batches whose local
    blocks hold ``local`` rows each (FixMatch's ``[labeled; mixed]``: the
    rows ``[r nl, (r+1) nl)`` and ``Bl + [r nu, (r+1) nu)``), as int64."""
    out, base = [], 0
    for n in local:
        total, rows = row_block(mesh, n)
        out.append(torch.arange(base + rows.start, base + rows.stop))
        base += total
    return torch.cat(out)


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """This rank's contiguous row block of every entry of a global batch:
    the rows the ``Loader`` assembles for it with ``process_index = rank``."""
    out = {}
    for k, v in batch.items():
        _, rows = row_block(mesh, v.shape[0] // size(mesh))
        out[k] = v[rows]
    return out


def _all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dist.all_reduce(t, group=mesh.group)
    COUNTS["collectives"] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the cotangent over ranks too (the
    adjoint of a sum that every rank sees).  Under ``torch.func.vmap`` (CPS's
    ``stacked`` form) the batched tensor is reduced as a whole."""

    @staticmethod
    def forward(x, mesh):
        return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.mesh), None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _AllReduceSum.apply(x, mesh), in_dims[0]


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh`` (every rank gets the same
    bits); differentiable.  ``x`` itself where no collective launches."""
    if not launches(mesh):
        return x
    return _AllReduceSum.apply(x, mesh)


Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


def gather_rows(x: Rows, mesh: Optional[Mesh]) -> Rows:
    """Every rank's ``x`` stacked on a new leading rank axis ([R, *x.shape]),
    bit for bit: one ``all_reduce`` of a zero byte buffer in which each rank
    fills its own slot (uint8 sums with zeros are exact, -0.0 and NaN
    included).  A sequence of tensors goes through one collective and comes
    back as a list.  No gradient.  ``x[None]`` where no collective launches."""
    single = isinstance(x, torch.Tensor)
    xs = [x] if single else list(x)
    if not launches(mesh):
        out = [t[None] for t in xs]
        return out[0] if single else out
    xs = [t.detach().contiguous() for t in xs]
    sizes = [t.numel() * t.element_size() for t in xs]
    slot = sum(sizes)
    buf = torch.zeros((mesh.size, slot), dtype=torch.uint8, device=xs[0].device)
    off = 0
    for t, n in zip(xs, sizes):
        buf[mesh.rank, off:off + n].copy_(t.reshape(-1).view(torch.uint8))
        off += n
    _all_reduce_(buf, mesh)
    out, off = [], 0
    for t, n in zip(xs, sizes):
        out.append(buf[:, off:off + n].contiguous().view(t.dtype).reshape((mesh.size,) + t.shape))
        off += n
    return out[0] if single else out


def partner_rows(x: Rows, mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """CutMix's roll-by-1 partner of local row 0: the last row of rank
    ``r - 1`` (of rank ``R - 1`` for rank 0), for each tensor of ``x``; the
    batch's own last row where no collective launches."""
    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    if not launches(mesh):
        return [t[-1] for t in xs]
    rows = gather_rows([t[-1] for t in xs], mesh)
    return [r[(mesh.rank - 1) % mesh.size] for r in rows]


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    out = []
    for o in obj:
        out += _tensors(o) if isinstance(o, nn.Module) else [o]
    return out


def _flat_groups(tensors: Iterable[torch.Tensor]):
    groups: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


@torch.no_grad()
def broadcast_from_rank0(obj, mesh: Optional[Mesh]) -> None:
    """Overwrite, in place, every parameter and buffer of ``obj`` (a module,
    or a sequence of modules and tensors) with world rank 0's: one
    ``broadcast`` over the world of a flat buffer per dtype and device.
    Nothing where no collective launches."""
    mesh = None if mesh is None else mesh.world
    if not launches(mesh):
        return
    for ts in _flat_groups(_tensors(obj)):
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        COUNTS["collectives"] += 1
        COUNTS["bytes"] += flat.numel() * flat.element_size()
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sum the gradients over every rank in place: every existing ``.grad``
    in one flat buffer per dtype and device, one ``all_reduce`` over the
    world each, in the same order on every rank.  Nothing where no
    collective launches.

    Under a model axis of M ranks a parameter marked ``model_partial`` (the
    H-sharded stem's, ``models/layers.py::use_mesh``) holds the share of this
    rank's H rows, and every other one the whole gradient of its data rank,
    the same on the M model ranks: those are scaled by 1/M first (exact for
    M a power of two), so that one sum over the world leaves every rank the
    data-summed whole gradient, with the same bits on every rank."""
    world = None if mesh is None else mesh.world
    if not launches(world):
        return
    grads = []
    for p in params:
        if p.grad is None:
            continue
        if mesh.model_size > 1 and not getattr(p, "model_partial", False):
            p.grad.div_(mesh.model_size)
        grads.append(p.grad)
    for gs in _flat_groups(grads):
        flat = _all_reduce_(torch.cat([g.reshape(-1) for g in gs]), world)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the world meets here."""
    if mesh is not None and launches(mesh.world):
        dist.barrier(group=mesh.world.group)
