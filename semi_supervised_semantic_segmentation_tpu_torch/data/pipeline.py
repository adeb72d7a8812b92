"""Host input pipeline: epoch loaders and the SSL dual loader.

Port-owned copy of the reference's numpy-only ``data/pipeline.py``: a
background thread assembles uint8 canvas batches through a thread pool into
a bounded queue; the same seed gives byte-equal batches on both sides.
With ``process_count`` > 1 each process yields its own contiguous row block
of every global batch, as the reference's multi-host loader does.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from semi_supervised_semantic_segmentation_tpu_torch.data.datasets import SegDataset

Batch = Dict[str, np.ndarray]


def _assemble(dataset: SegDataset, indices, canvas_hw: Tuple[int, int], pool) -> Batch:
    hc, wc = canvas_hw
    b = len(indices)
    images = np.zeros((b, hc, wc, 3), dtype=np.uint8)
    labels = np.full((b, hc, wc), 255, dtype=np.int32)
    sizes = np.zeros((b, 2), dtype=np.int32)

    def fill(slot_index):
        slot, index = slot_index
        if index < 0:  # blank pad slot (eval): all-ignore labels, zero image
            sizes[slot] = (1, 1)
            return
        sizes[slot] = dataset.get_into(int(index), images[slot], labels[slot])

    list(pool.map(fill, enumerate(indices)))
    return {
        "image": images,
        "label": labels,
        "size": sizes,
        "index": np.asarray(indices, dtype=np.int32),
    }


class Loader:
    """Epoch-based batch loader with deterministic per-epoch shuffling."""

    def __init__(
        self,
        dataset: SegDataset,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        canvas_hw: Optional[Tuple[int, int]] = None,
        pad_mode: str = "wrap",  # 'wrap' (train) | 'blank' (eval: exact count)
        process_index: int = 0,
        process_count: int = 1,
    ):
        # Every process computes the same global order and assembles only
        # its contiguous row block of each global batch.
        assert batch_size % process_count == 0, (batch_size, process_count)
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size = batch_size // process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.canvas_hw = canvas_hw or dataset.canvas_hw
        self.prefetch = prefetch
        self.pad_mode = pad_mode
        self._pool = ThreadPoolExecutor(max_workers=max(num_workers, 1))
        self._closed = False

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return max(n // self.batch_size, 1)
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed * 1_000_003 + epoch).shuffle(order)
        total = len(self) * self.batch_size
        if total > n:
            if self.pad_mode == "wrap":
                order = np.resize(order, total)
            else:
                order = np.concatenate([order, np.full(total - n, -1, dtype=order.dtype)])
        return order[:total]

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """Iterate one epoch with background prefetch."""
        batches = self._epoch_indices(epoch).reshape(-1, self.batch_size)
        lo = self.process_index * self.local_batch_size
        batches = batches[:, lo:lo + self.local_batch_size]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            try:
                for idxs in batches:
                    if self._closed:
                        break
                    q.put(_assemble(self.dataset, idxs, self.canvas_hw, self._pool))
            except RuntimeError:
                if not self._closed:  # the pool refuses work only after close()
                    raise
            finally:
                q.put(sentinel)

        threading.Thread(target=produce, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item

    def cycle(self, start_epoch: int = 0) -> Iterator[Batch]:
        """Endless stream (the labeled loader in the zip pattern)."""
        epoch = start_epoch
        while True:
            yield from self.epoch(epoch)
            epoch += 1

    def close(self) -> None:
        """Stop producing and release the worker threads."""
        self._closed = True
        self._pool.shutdown(wait=False)


class DualLoader:
    """zip(cycle(labeled), unlabeled): the unlabeled pass defines the epoch,
    the labeled loader recycles."""

    def __init__(self, labeled: Loader, unlabeled: Loader):
        self.labeled = labeled
        self.unlabeled = unlabeled
        self._labeled_iter: Optional[Iterator[Batch]] = None

    def __len__(self) -> int:
        return len(self.unlabeled)

    def epoch(self, epoch: int) -> Iterator[Tuple[Batch, Batch]]:
        if self._labeled_iter is None:
            self._labeled_iter = self.labeled.cycle(start_epoch=epoch)
        for unlab in self.unlabeled.epoch(epoch):
            yield next(self._labeled_iter), unlab
