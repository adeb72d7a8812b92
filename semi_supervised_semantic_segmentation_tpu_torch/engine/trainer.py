"""Training engine (counterpart of ``engine/trainer.py``).

Host loaders assemble uint8 canvases; a background thread copies the next
batch to the device (pinned memory, on a side CUDA stream, so the copy
overlaps the running step) while the main thread runs the method's step.
The resolved config is written to ``<work_dir>/config.yaml``.  Scalars are
fetched from the device only at log intervals and written besides the log
as one JSON line each to ``<work_dir>/metrics.jsonl``, in the reference's
record shape (``MetricLogger.log_scalars``): ``{"train": {"step", "time",
...}}`` with step = i + epoch * iters_per_epoch, the 0-based index of the
step just run, and time in seconds since the logger was made.

Evaluation, checkpoints and resume are not ported yet (ROADMAP.md Queue 1
items 1-3); ``fit`` says so in one log line and only trains.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import torch

from semi_supervised_semantic_segmentation_tpu_torch import resolve_device
from semi_supervised_semantic_segmentation_tpu_torch.config import Config, save_config
from semi_supervised_semantic_segmentation_tpu_torch.data.datasets import build_dataset
from semi_supervised_semantic_segmentation_tpu_torch.data.pipeline import DualLoader, Loader
from semi_supervised_semantic_segmentation_tpu_torch.methods import common, get_method
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model

log = logging.getLogger("sstpu_torch")


class _Prefetcher:
    """Background thread: host batch pairs -> device tensors, ``depth``
    ahead.  On CUDA the copies run on a side stream; ``get`` makes the
    current stream wait for them.  ``close`` ends the thread, which would
    otherwise wait on the full queue forever and keep the trainer (its
    model, optimizer state and batches) alive."""

    def __init__(self, pairs: Iterator, device: torch.device, depth: int = 2):
        self.device = device
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._sentinel = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(pairs,), daemon=True)
        self._thread.start()

    def _produce(self, pairs):
        try:
            for lab, unlab in pairs:
                if self._stop.is_set():
                    break
                if self.stream is None:
                    self.q.put((common.to_device(lab, self.device),
                                common.to_device(unlab, self.device), None))
                    continue
                with torch.cuda.stream(self.stream):
                    item = (common.to_device(lab, self.device, non_blocking=True),
                            common.to_device(unlab, self.device, non_blocking=True))
                    event = torch.cuda.Event()
                    event.record(self.stream)
                self.q.put((*item, event))
        except Exception as e:  # surfaced to the training thread by get()
            self.q.put(e)
        finally:
            self.q.put(self._sentinel)

    def get(self):
        item = self.q.get()
        if item is self._sentinel:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        lab, unlab, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in (*lab.values(), *unlab.values()):
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


class MetricLogger:
    """The JSON-lines half of the reference's ``utils/logging.py``
    ``MetricLogger`` (the card's machine has no tensorboardX)."""

    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "metrics.jsonl")
        self._t0 = time.time()

    def log_scalars(self, step: int, scalars: Dict[str, float], prefix: str = "train") -> dict:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps({prefix: rec}) + "\n")
        return rec


class Trainer:
    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        torch.manual_seed(cfg.train.seed)
        self.method = get_method(cfg.method.name)
        self.model = build_model(cfg).to(self.device)

        t = cfg.train
        self.labeled_loader = Loader(build_dataset(cfg, "labeled"), t.labeled_batch_size,
                                     seed=t.seed, num_workers=cfg.data.num_workers)
        self.unlabeled_loader = Loader(build_dataset(cfg, "unlabeled"), t.unlabeled_batch_size,
                                       seed=t.seed + 17, num_workers=cfg.data.num_workers)
        self.dual = DualLoader(self.labeled_loader, self.unlabeled_loader)
        self.iters_per_epoch = t.iters_per_epoch or len(self.dual)
        self.total_steps = self.iters_per_epoch * t.epochs

        self.state = self.method.init_state(cfg, self.model, self.total_steps)
        self.train_step = self.method.make_train_step(cfg, self.total_steps)
        self._prefetch: Optional[_Prefetcher] = None
        os.makedirs(t.work_dir, exist_ok=True)
        save_config(cfg, os.path.join(t.work_dir, "config.yaml"))
        self.metrics = MetricLogger(t.work_dir)
        log.info("device=%s (%s) model=%s/%s stem_impl=%s branch_conv=%s remat=%s "
                 "cutmix_impl=%s sup_loss=%s steps=%d",
                 self.device, torch.cuda.get_device_name(self.device)
                 if self.device.type == "cuda" else "cpu",
                 cfg.model.backbone, cfg.model.decoder, cfg.model.stem_impl,
                 cfg.model.branch_conv, cfg.model.remat, cfg.data.cutmix_impl,
                 cfg.method.sup_loss, self.total_steps)

    def _pairs(self, start_epoch: int):
        epoch = start_epoch
        while True:
            yield from self.dual.epoch(epoch)
            epoch += 1

    def batches(self, epoch: int):
        """``iters_per_epoch`` device batch pairs from the persistent
        prefetched stream."""
        if self._prefetch is None:
            self._prefetch = _Prefetcher(self._pairs(epoch), self.device)
        for _ in range(self.iters_per_epoch):
            yield self._prefetch.get()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        t0, n_img, host = time.time(), 0, {}
        for i, (lab, unlab) in enumerate(self.batches(epoch)):
            last = self.train_step(self.state, lab, unlab)
            n_img += lab["image"].shape[0] + unlab["image"].shape[0]
            if (i + 1) % cfg.train.log_interval == 0 or i + 1 == self.iters_per_epoch:
                host = {k: float(v) for k, v in last.items()}  # syncs the device
                host["images_per_sec"] = n_img / (time.time() - t0)
                t0, n_img = time.time(), 0
                rec = self.metrics.log_scalars(i + epoch * self.iters_per_epoch, host, "train")
                log.info("epoch %d iter %d/%d %s", epoch, i + 1, self.iters_per_epoch,
                         json.dumps(rec))
        return host

    def fit(self) -> Dict[str, float]:
        log.info("evaluation, checkpoints and resume are not ported yet "
                 "(ROADMAP.md Queue 1 items 1-3): training only")
        last = {}
        try:
            for epoch in range(self.cfg.train.epochs):
                last = self.train_epoch(epoch)
        finally:
            self.close()
        return last

    def close(self) -> None:
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
        self.labeled_loader.close()
        self.unlabeled_loader.close()
