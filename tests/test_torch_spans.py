"""The port's spans and counters (``utils/spans.py``, ``engine/trainer.py``),
on the CPU:

- with spans off, a profiler that records user ranges sees none from one
  FixMatch step; with them on, each ``fixmatch.*`` phase once, in order,
  nested in ``fixmatch.step``, and the ``branch_conv.*`` spans of kernels D
  and E's plain versions (config 5's model, reduced: HRNet width 8, one
  module a stage, crop 128, so branch 0 takes the branch-conv path);
- the prefetcher's counters under a slow producer;
- the trainer's collector hook: one, counted, removed by ``close``.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig
from torch.autograd import ProfilerActivity

from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import trainer as trainer_mod
from semi_supervised_semantic_segmentation_tpu_torch.methods import fixmatch
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.utils import spans
from tests.torch_port_helpers import one_torch_thread

CROP, NCLS = 128, 5
RAW = {
    "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP},
    "model": {"backbone": "hrnet_w48", "decoder": "hrnet_head", "compute_dtype": "float32",
              "hrnet_width": 8, "hrnet_modules": [1, 1, 1], "head_fuse": "up_first",
              "branch_conv": "pallas", "remat": "stages:3"},
    "method": {"name": "fixmatch_cutmix", "conf_thresh": 0.3, "sup_loss": "ohem",
               "ohem_min_kept": 1000},
    "train": {"labeled_batch_size": 1, "unlabeled_batch_size": 1},
}
PHASES = ["fixmatch.draw", "fixmatch.views", "fixmatch.teacher", "fixmatch.cutmix",
          "fixmatch.student", "fixmatch.loss", "fixmatch.backward", "fixmatch.optimizer",
          "fixmatch.ema"]


def _user_ranges(fn):
    """Run ``fn`` under a profiler that records CPU activity at
    ``RecordScope.USER_SCOPE`` alone; (name, start_ns, end_ns) of its ranges."""
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    torch.autograd._prepare_profiler(cfg, acts)
    torch.autograd._enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        fn()
    finally:
        result = torch.autograd._disable_profiler()
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in result.events()
                   if e.is_user_annotation()), key=lambda r: r[1])


@pytest.fixture(scope="module")
def one_step():
    """A step function and its state, the first step already run (so that
    the profiled step is a warm one), and the batches."""
    with one_torch_thread():
        cfg = config.config_from_dict(RAW)
        torch.manual_seed(0)
        state = fixmatch.init_state(cfg, build_model(cfg), 4)
        step = fixmatch.make_train_step(cfg, 4)
        rng = np.random.RandomState(0)

        def batch(labeled):
            image = (rng.rand(1, CROP, CROP, 3) * 255).astype(np.uint8)
            label = (rng.randint(0, NCLS, (1, CROP, CROP)) if labeled
                     else np.full((1, CROP, CROP), 255)).astype(np.int32)
            return {"image": torch.from_numpy(image), "label": torch.from_numpy(label),
                    "size": torch.full((1, 2), CROP, dtype=torch.int32)}

        lab, unlab = batch(True), batch(False)
        step(state, lab, unlab)
        yield lambda: step(state, lab, unlab)


def test_spans_off_record_no_range(one_step):
    with one_torch_thread():
        assert _user_ranges(one_step) == []


def test_spans_on_record_each_phase_once_in_order_inside_the_step(one_step):
    with one_torch_thread(), spans.recording():
        ranges = _user_ranges(one_step)
    assert not spans._recording  # recording() restored the flag
    steps = [r for r in ranges if r[0] == "fixmatch.step"]
    assert len(steps) == 1
    _, a, b = steps[0]
    phases = [r for r in ranges if r[0] in PHASES]
    assert [r[0] for r in phases] == PHASES
    assert all(a <= s <= e <= b for _, s, e in phases)
    assert all(e0 <= s1 for (_, _, e0), (_, s1, _) in zip(phases, phases[1:]))
    names = {r[0] for r in ranges}
    assert names <= {"fixmatch.step", *PHASES, "branch_conv.d", "branch_conv.d_post",
                     "branch_conv.e"}
    convs = [r for r in ranges if r[0].startswith("branch_conv.")]
    assert {r[0] for r in convs} == {"branch_conv.d", "branch_conv.d_post", "branch_conv.e"}
    within = {n: (s, e) for n, s, e in phases}
    # D in the forwards, the re-run and the backward's dx; E and D's post
    # mode in the backward alone
    for n, s, e in convs:
        assert a <= s <= e <= b
        if n != "branch_conv.d":
            assert within["fixmatch.backward"][0] <= s <= e <= within["fixmatch.backward"][1]
    for p in ("fixmatch.teacher", "fixmatch.student", "fixmatch.backward"):
        lo, hi = within[p]
        assert any(n == "branch_conv.d" and lo <= s <= hi for n, s, _ in convs), p


def test_prefetcher_counts_the_gets_that_waited():
    def slow():
        for k in range(3):
            time.sleep(0.05)
            yield {"image": torch.full((1,), k)}, None

    pre = trainer_mod._Prefetcher(slow(), torch.device("cpu"))
    try:
        got = [pre.get()[0]["image"].item() for _ in range(3)]
        with pytest.raises(StopIteration):
            pre.get()
    finally:
        pre.close()
    assert got == [0, 1, 2]
    assert pre.gets == 4
    assert 1 <= pre.empty_gets <= 4
    assert pre.waited_ns >= 50_000_000  # the first get waits out the first sleep


def test_prefetcher_counts_no_wait_on_a_full_queue():
    ready = threading.Event()

    def pairs():
        for k in range(2):
            yield {"image": torch.full((1,), k)}, None
        ready.set()

    pre = trainer_mod._Prefetcher(pairs(), torch.device("cpu"))
    try:
        assert ready.wait(10)
        deadline = time.monotonic() + 10
        while pre.q.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        pre.get()
    finally:
        pre.close()
    assert (pre.gets, pre.empty_gets) == (1, 0)


def test_trainer_hooks_the_collector_once_and_close_removes_it(tmp_path):
    cfg = config.config_from_dict({
        "data": {"dataset": "synthetic", "crop_size": 32, "synthetic_canvas": 32,
                 "synthetic_size": 4, "num_workers": 1},
        "model": {"backbone": "resnet18", "decoder": "unet", "compute_dtype": "float32"},
        "method": {"name": "supervised"},
        "train": {"labeled_batch_size": 2, "work_dir": str(tmp_path),
                  "async_checkpoint": False}})
    before = list(gc.callbacks)
    trainer = trainer_mod.Trainer(cfg, device="cpu")
    try:
        added = [cb for cb in gc.callbacks if cb not in before]
        assert added == [trainer.collector]
        assert (trainer.collector.gc_full_collections, trainer.collector.gc_pause_ns) == (0, 0)
        gc.collect(1)
        assert trainer.collector.gc_full_collections == 0
        gc.collect()
        assert trainer.collector.gc_full_collections == 1
        assert trainer.collector.gc_pause_ns > 0
    finally:
        trainer.close()
    assert gc.callbacks == before
    trainer.close()  # a second close leaves the hooks as they are
    assert gc.callbacks == before
