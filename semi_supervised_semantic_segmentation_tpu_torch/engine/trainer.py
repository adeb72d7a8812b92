"""Training engine (counterpart of ``engine/trainer.py``).

Host loaders assemble uint8 canvases; a background thread copies the next
batch to the device (pinned memory, on a side CUDA stream, so the copy
overlaps the running step) while the main thread runs the method's step.
Methods without unlabeled data (``uses_unlabeled`` false) get one loader:
the epoch is the labeled loader's, and their step receives ``None`` for the
unlabeled batch.  The resolved config is written to
``<work_dir>/config.yaml``.  Scalars are fetched from the device only at
log intervals and written besides the log as one JSON line each to
``<work_dir>/metrics.jsonl``, in the reference's record shape
(``utils/logging.py::MetricLogger``): ``{"train": {"step", "time", ...}}`` with
step = i + epoch * iters_per_epoch, the 0-based index of the step just run,
and time in seconds since the logger was made; and as TensorBoard scalars
in ``<work_dir>/tb`` where ``tensorboardX`` imports.

``fit`` runs epochs ``start_epoch`` .. ``train.epochs - 1``, evaluates every
``train.eval_interval`` epochs and after the last one, on the EMA teacher
where the method has one and on net1 for CPS (``engine/evaluator.py``), writes a ``{"val":
{"step": epoch, "time", "miou", "acc", "iou/<name>", ...}}`` record and
returns the best mIoU.  Checkpoints (``engine/checkpoint.py``): a better
mIoU writes the one slot of ``<work_dir>/checkpoints_best``; every
``train.checkpoint_interval`` epochs and after the last, a rolling slot goes
to ``<work_dir>/checkpoints`` (``train.keep_checkpoints`` kept; written on
a thread with ``train.async_checkpoint``).  ``train.resume`` ('auto', a
checkpoint directory or ``dir:step``) restores a slot at construction:
training starts at its epoch + 1 with its best mIoU, and the batch stream at
that data epoch.  ``train.init_from_torch`` starts from a reference-layout
checkpoint file (``engine/compat.py``).

Data parallelism: under an initialized process group (``python -m
torch.distributed.run``; ``parallel.distributed.maybe_initialize``) the
trainer builds the data mesh of ``parallel.*`` (``parallel/mesh.py``).
Each rank computes on its card (``parallel.distributed.rank_device``),
loads its row block of every global batch (the batch sizes are global),
starts from rank 0's parameters and buffers (broadcast after
construction, ``init_from_torch`` and resume) and runs the method's step
with the mesh, which makes every reduction global and keeps the ranks'
states bit-equal.  With ``parallel.model_parallel: M > 1`` the processes
form a data x model mesh: the M model ranks of a data rank load the same
rows and H-shard HRNet's stem between them (``models/hrnet.py``).  World
rank 0 alone writes ``config.yaml``, ``metrics.jsonl``, the TensorBoard
scalars, ``train.log`` and the checkpoints; the eval's confusion matrix is
global.

``train.profile_steps = n`` traces the first epoch's steps 2 .. 2 + n with
``torch.profiler`` into ``<work_dir>/profile/`` (a Chrome trace), with the
program's spans recording (``utils/spans.py``: ``fixmatch.*``,
``branch_conv.*``, ``data.wait``).  Counters for a profiler or a harness to
read: the prefetcher's (``trainer._prefetch``: ``gets``, ``empty_gets``,
``waited_ns``) and the collector's (``trainer.collector``:
``gc_full_collections``, ``gc_pause_ns``, from a ``gc.callbacks`` hook that
``__init__`` adds and :meth:`close` removes).
``train.debug_nans`` runs each step under autograd's anomaly mode (a
backward function that returns NaN raises) and raises when a step's scalars
are not finite.  That is weaker than the reference's ``jax_debug_nans``,
which checks the output of every op, forward ones included.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import math
import os
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import torch

from semi_supervised_semantic_segmentation_tpu_torch.config import Config, save_config
from semi_supervised_semantic_segmentation_tpu_torch.data.datasets import build_dataset
from semi_supervised_semantic_segmentation_tpu_torch.data.pipeline import DualLoader, Loader
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    parse_checkpoint_arg,
)
from semi_supervised_semantic_segmentation_tpu_torch.engine.evaluator import (
    inference_model,
    make_evaluator,
    run_eval,
    val_loader,
)
from semi_supervised_semantic_segmentation_tpu_torch.methods import common, get_method
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.ops.metrics import (
    class_names,
    format_iou_table,
)
from semi_supervised_semantic_segmentation_tpu_torch.parallel.distributed import rank_device
from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import (
    broadcast_from_rank0,
    make_mesh,
)
from semi_supervised_semantic_segmentation_tpu_torch.utils import spans
from semi_supervised_semantic_segmentation_tpu_torch.utils.logging import (
    MetricLogger,
    log_to_file,
)

log = logging.getLogger("sstpu_torch")


class _Prefetcher:
    """Background thread: host batch pairs (the unlabeled one may be
    ``None``) -> device tensors, ``depth`` ahead.  On CUDA the copies run on
    a side stream; ``get`` makes the current stream wait for them.
    ``close`` ends the thread, which would otherwise wait on the full queue
    forever and keep the trainer (its model, optimizer state and batches)
    alive.  Counters (plain ints, read by whoever holds the prefetcher):
    ``gets``, ``empty_gets`` (gets that found the queue empty) and
    ``waited_ns`` (time in ``get``'s queue wait, the span ``data.wait``)."""

    def __init__(self, pairs: Iterator, device: torch.device, depth: int = 2):
        self.device = device
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._sentinel = object()
        self._stop = threading.Event()
        self.gets = self.empty_gets = self.waited_ns = 0
        self._thread = threading.Thread(target=self._produce, args=(pairs,), daemon=True)
        self._thread.start()

    def _copy(self, pair, non_blocking: bool = False):
        return tuple(None if b is None else common.to_device(b, self.device, non_blocking)
                     for b in pair)

    def _produce(self, pairs):
        try:
            for pair in pairs:
                if self._stop.is_set():
                    break
                if self.stream is None:
                    self.q.put((*self._copy(pair), None))
                    continue
                with torch.cuda.stream(self.stream):
                    item = self._copy(pair, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self.stream)
                self.q.put((*item, event))
        except Exception as e:  # surfaced to the training thread by get()
            self.q.put(e)
        finally:
            self.q.put(self._sentinel)

    def get(self):
        t0 = time.perf_counter_ns()
        with spans.span("data.wait"):
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                self.empty_gets += 1
                item = self.q.get()
        self.waited_ns += time.perf_counter_ns() - t0
        self.gets += 1
        if item is self._sentinel:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        lab, unlab, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for b in (lab, unlab):
                for t in (b or {}).values():
                    t.record_stream(cur)
        return lab, unlab

    def close(self) -> None:
        """Stop the thread: drain the queue until it has put its last item."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass


class _Collector:
    """A ``gc.callbacks`` hook that counts the collector's full (generation
    2) collections, ``gc_full_collections``, and their pause, ``gc_pause_ns``.
    It makes no torch call: it runs inside the collection, on whichever
    thread triggered it."""

    def __init__(self):
        self.gc_full_collections = self.gc_pause_ns = 0
        self._t0 = 0

    def __call__(self, phase: str, info: Dict[str, int]) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter_ns()
        else:
            self.gc_full_collections += 1
            self.gc_pause_ns += time.perf_counter_ns() - self._t0


class Trainer:
    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.mesh = mesh = make_mesh(cfg.parallel.data_parallel, cfg.parallel.model_parallel)
        self.rank0 = mesh.world_rank == 0
        self.device = rank_device(device)
        torch.manual_seed(cfg.train.seed)
        self.method = get_method(cfg.method.name)
        self.model = build_model(cfg, mesh=mesh).to(self.device)

        t = cfg.train
        # the batch sizes are global: each process loads its row block
        self.labeled_loader = Loader(build_dataset(cfg, "labeled"), t.labeled_batch_size,
                                     seed=t.seed, num_workers=cfg.data.num_workers,
                                     process_index=mesh.rank, process_count=mesh.size)
        if self.method.uses_unlabeled:
            self.unlabeled_loader = Loader(build_dataset(cfg, "unlabeled"),
                                           t.unlabeled_batch_size, seed=t.seed + 17,
                                           num_workers=cfg.data.num_workers,
                                           process_index=mesh.rank, process_count=mesh.size)
            self.dual = DualLoader(self.labeled_loader, self.unlabeled_loader)
            self.iters_per_epoch = t.iters_per_epoch or len(self.dual)
        else:
            self.unlabeled_loader = self.dual = None
            self.iters_per_epoch = t.iters_per_epoch or len(self.labeled_loader)
        self.val_loader = val_loader(cfg, mesh)
        self.total_steps = self.iters_per_epoch * t.epochs

        # CPS's init_state adds net2 on the model's device
        self.state = self.method.init_state(cfg, self.model, self.total_steps)
        self.train_step = self.method.make_train_step(cfg, self.total_steps, mesh)
        self.eval_step = make_evaluator(cfg)
        self.start_epoch = 0
        self.best_miou = 0.0
        self.last: Dict[str, float] = {}
        self._prefetch: Optional[_Prefetcher] = None
        os.makedirs(t.work_dir, exist_ok=True)
        self._log_file = None
        if self.rank0:
            save_config(cfg, os.path.join(t.work_dir, "config.yaml"))
            self._log_file = log_to_file(log, t.work_dir)
        self.metrics = MetricLogger(t.work_dir, write=self.rank0)
        self.ckpt = CheckpointManager(os.path.join(t.work_dir, "checkpoints"),
                                      max_to_keep=t.keep_checkpoints,
                                      async_save=t.async_checkpoint, mesh=mesh)
        # the best-mIoU snapshot: one slot, written only on improvement, so
        # the best model outlives the rolling window
        self.ckpt_best = CheckpointManager(os.path.join(t.work_dir, "checkpoints_best"),
                                           max_to_keep=1, async_save=t.async_checkpoint,
                                           mesh=mesh)
        log.info("device=%s (%s) model=%s/%s stem_impl=%s branch_conv=%s remat=%s "
                 "cutmix_impl=%s sup_loss=%s steps=%d mesh=%s world rank=%d",
                 self.device, torch.cuda.get_device_name(self.device)
                 if self.device.type == "cuda" else "cpu",
                 cfg.model.backbone, cfg.model.decoder, cfg.model.stem_impl,
                 cfg.model.branch_conv, cfg.model.remat, cfg.data.cutmix_impl,
                 cfg.method.sup_loss, self.total_steps, mesh.shape, mesh.world_rank)
        if t.init_from_torch:
            # reference-layout interop: weights, EMA teacher and momentum
            # from a torch.save checkpoint file
            compat.import_reference_checkpoint(t.init_from_torch, self.state)
            log.info("initialized from reference torch checkpoint %s (step=%d)",
                     t.init_from_torch, self.state.step)
        if t.resume:
            self._resume(t.resume)
        # every rank starts from rank 0's state, bit for bit
        broadcast_from_rank0(self._state_tensors(), mesh)
        self.collector = _Collector()
        gc.callbacks.append(self.collector)

    def _state_tensors(self):
        """The nets (teacher included) and the optimizer's momentum."""
        nets = self.state.nets() + [n for n in (self.state.ema_model,) if n is not None]
        return nets + [b for bufs in self.state.optimizer.bufs for b in bufs]

    def _resume(self, resume: str) -> None:
        """resume: 'auto' (the latest slot of ``<work_dir>/checkpoints``), a
        checkpoint directory, or ``dir:step``."""
        directory, step = parse_checkpoint_arg(
            os.path.join(self.cfg.train.work_dir, "checkpoints") if resume == "auto" else resume)
        mgr = (self.ckpt if os.path.abspath(directory) == self.ckpt.directory
               else CheckpointManager(directory, mesh=self.mesh))
        if mgr.latest_step() is None:
            log.info("resume requested but no checkpoint found in %s", directory)
            return
        meta = mgr.restore(self.state, step)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.best_miou = float(meta.get("best_miou", 0.0))
        log.info("resumed from %s step=%d -> start_epoch=%d best_miou=%.4f",
                 directory, self.state.step, self.start_epoch, self.best_miou)

    def _pairs(self, start_epoch: int):
        epoch = start_epoch
        while True:
            if self.dual is not None:
                yield from self.dual.epoch(epoch)
            else:
                for lab in self.labeled_loader.epoch(epoch):
                    yield lab, None
            epoch += 1

    def batches(self, epoch: int):
        """``iters_per_epoch`` device batch pairs from the persistent
        prefetched stream, which starts at data epoch ``epoch``."""
        if self._prefetch is None:
            self._prefetch = _Prefetcher(self._pairs(epoch), self.device)
        for _ in range(self.iters_per_epoch):
            yield self._prefetch.get()

    def _step(self, lab, unlab) -> Dict[str, object]:
        if not self.cfg.train.debug_nans:
            return self.train_step(self.state, lab, unlab)
        with torch.autograd.set_detect_anomaly(True):
            last = self.train_step(self.state, lab, unlab)
        bad = {k: float(v) for k, v in last.items() if not math.isfinite(float(v))}
        if bad:
            raise FloatingPointError(f"train.debug_nans: step {self.state.step - 1} gave "
                                     f"non-finite scalars {bad}")
        return last

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        t0, n_img, host = time.time(), 0, {}
        prof, last_profiled = None, 2 + cfg.train.profile_steps
        for i, (lab, unlab) in enumerate(self.batches(epoch)):
            if cfg.train.profile_steps > 0 and epoch == self.start_epoch and i == 2:
                prof = self._start_profile()  # from the third step: past the warm-up
            last = self._step(lab, unlab)
            n_img += lab["image"].shape[0] + (0 if unlab is None else unlab["image"].shape[0])
            if prof is not None and (i == last_profiled or i + 1 == self.iters_per_epoch):
                self._stop_profile(prof, epoch, i)
                prof = None
            if (i + 1) % cfg.train.log_interval == 0 or i + 1 == self.iters_per_epoch:
                host = {k: float(v) for k, v in last.items()}  # syncs the device
                host["images_per_sec"] = n_img * self.mesh.size / (time.time() - t0)
                t0, n_img = time.time(), 0
                rec = self.metrics.log_scalars(i + epoch * self.iters_per_epoch, host, "train")
                log.info("epoch %d iter %d/%d %s", epoch, i + 1, self.iters_per_epoch,
                         json.dumps(rec))
        return host

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        self._profiling = contextlib.ExitStack()
        self._profiling.enter_context(spans.recording())
        self._profiling.enter_context(prof)
        return prof

    def _stop_profile(self, prof, epoch: int, last: int) -> None:
        """End the trace after step ``last`` (its kernels done) and write it
        to ``<work_dir>/profile/trace_epoch<epoch>_steps2-<last>.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiling.close()  # the profiler stops, then the spans
        out = os.path.join(self.cfg.train.work_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_epoch{epoch}_steps2-{last}.json")
        prof.export_chrome_trace(path)
        log.info("profile of steps 2-%d of epoch %d written to %s", last, epoch, path)

    def evaluate(self, epoch: int) -> float:
        """One pass over the val set: logs the IoU table, writes the ``val``
        record (finite IoUs only, as the reference) and returns the mIoU."""
        cfg = self.cfg
        t0 = time.time()
        iou, miou, acc = run_eval(self.eval_step, inference_model(self.state, self.method),
                                  self.val_loader, self.device, mesh=self.mesh)
        names = class_names(cfg.data.dataset, cfg.data.num_classes)
        log.info("eval epoch %d: mIoU=%.4f acc=%.4f (%.1fs)\n%s", epoch, miou, acc,
                 time.time() - t0, format_iou_table(iou, names))
        scalars = {"miou": miou, "acc": acc}
        scalars.update({f"iou/{n}": float(v) for n, v in zip(names, iou) if math.isfinite(v)})
        self.metrics.log_scalars(epoch, scalars, "val")
        return miou

    def _meta(self, epoch: int, miou: float) -> dict:
        return {"epoch": epoch, "best_miou": self.best_miou, "miou": miou,
                "config": self.cfg.to_dict()}

    def fit(self) -> float:
        """Train, evaluate and checkpoint as the module docstring says;
        returns the best mIoU.  The last interval's train scalars stay in
        ``self.last``."""
        t = self.cfg.train
        miou = 0.0
        try:
            for epoch in range(self.start_epoch, t.epochs):
                self.last = self.train_epoch(epoch)
                final = epoch + 1 == t.epochs
                if (epoch + 1) % t.eval_interval == 0 or final:
                    miou = self.evaluate(epoch)
                    if miou > self.best_miou:
                        self.best_miou = miou
                        self.ckpt_best.save(self.state.step, self.state,
                                            self._meta(epoch, miou), force=True)
                if (epoch + 1) % t.checkpoint_interval == 0 or final:
                    self.ckpt.save(self.state.step, self.state, self._meta(epoch, miou))
            self.ckpt.wait()
            self.ckpt_best.wait()
        finally:
            self.close()
        return self.best_miou

    def close(self) -> None:
        """Stop the prefetch thread and the loaders, finish the checkpoint
        writes in flight, close the records and remove the collector's hook."""
        if self.collector in gc.callbacks:
            gc.callbacks.remove(self.collector)
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
        for loader in (self.labeled_loader, self.unlabeled_loader, self.val_loader):
            if loader is not None:
                loader.close()
        self.ckpt.close()
        self.ckpt_best.close()
        self.metrics.close()
        if self._log_file is not None:
            log.removeHandler(self._log_file)
            self._log_file.close()
            self._log_file = None
