"""Multi-process bring-up on ``torch.distributed`` (counterpart of the
reference's ``parallel/distributed.py``).

``maybe_initialize()`` is called first by the entry points.  It triggers
when the environment says more than one process runs (``WORLD_SIZE > 1``,
as ``python -m torch.distributed.run --nproc_per_node R`` sets it, with
``MASTER_ADDR``/``MASTER_PORT``, ``RANK`` and ``LOCAL_RANK``) and is a
no-op otherwise, so a single process never touches ``torch.distributed``.

Each rank computes on ``cuda:(LOCAL_RANK % device_count)``, or on the CPU
when asked.  The backend carries only the collectives: ``nccl`` when every
local rank has a card of its own, ``gloo`` otherwise -- ranks that share a
card, and CPU ranks.  Gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` (through the host), which is all the port's collectives use
(``parallel/mesh.py``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch
import torch.distributed as dist

from semi_supervised_semantic_segmentation_tpu_torch import resolve_device

log = logging.getLogger("sstpu_torch")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` as given when it is
    explicit (``cpu``, ``cuda:N``); for ``None`` or ``cuda``, under an
    initialized group, the card ``LOCAL_RANK % device_count``; otherwise
    :func:`resolve_device`'s."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device) -> str:
    """``nccl`` when each local rank has a card of its own, else ``gloo``."""
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def maybe_initialize(device=None) -> bool:
    """Initialize the default process group from the ``torch.distributed.run``
    environment when ``WORLD_SIZE > 1``; a no-op (False) otherwise, or when a
    group already exists.  ``device``: the caller's ``--device`` (``cpu``
    puts the ranks, and so the backend, on the CPU)."""
    if _env_int("WORLD_SIZE", 1) <= 1 or dist.is_initialized():
        return False
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev)
    dist.init_process_group(backend, init_method="env://")
    log.info("torch.distributed: rank %d of %d, backend %s, device %s",
             dist.get_rank(), dist.get_world_size(), backend, dev)
    return True


def process_info() -> Dict[str, int]:
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1}
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size()}


def finalize() -> None:
    """Tear the default group down, if one exists."""
    if dist.is_initialized():
        dist.destroy_process_group()

