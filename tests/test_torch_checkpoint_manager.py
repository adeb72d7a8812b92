"""The port's checkpoint manager (``engine/checkpoint.py``) and resume
(``Trainer._resume``, ``fit``), on the CPU with U-Net/ResNet-18 at crop 32:

- a slot's layout (``checkpoint.pth``, ``meta.json``, ``rng.pth``),
  ``max_to_keep`` and the single best slot that ``fit`` writes;
- an asynchronous save written on a thread and joined by ``wait()``, and an
  error on that thread raised at ``wait()``;
- a slot half written at a crash (a temporary directory, a slot without its
  meta file) is never the latest;
- ``dir:step`` in ``train.resume`` and the eval entry point's loader;
- a restore into a different model names the missing and unexpected keys;
- a slot's ``.pth`` loads in the JAX package's
  ``compat.import_reference_checkpoint`` as an equal state (exactly);
- K epochs, a preemption, a resume and N - K more epochs end in the state
  of N epochs straight, bitwise (the pattern of
  ``tests/test_engine.py::test_checkpoint_roundtrip_bit_identical``, taken
  to ``Trainer.fit``): supervised, and Mean Teacher with its teacher.
"""

import json
import os
import shutil
import threading

import jax
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.methods import supervised as jsupervised
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval_cli
from semi_supervised_semantic_segmentation_tpu_torch.engine import checkpoint, compat
from semi_supervised_semantic_segmentation_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    parse_checkpoint_arg,
)
from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer
from semi_supervised_semantic_segmentation_tpu_torch.methods import supervised
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.test_torch_checkpoint import _assert_flat_equal, _jax_flat, _jax_momentum
from tests.torch_port_helpers import one_torch_thread

CROP = 32


@pytest.fixture(autouse=True)
def _one_torch_thread(tmp_path):
    with one_torch_thread():
        yield
    # the slots (115-172 MB each) would stay in the kept base temp dirs
    shutil.rmtree(tmp_path, ignore_errors=True)


def _raw(work_dir, method="supervised", **train):
    # split 'full': labeled and unlabeled sets of one size, so the labeled
    # stream of a resumed run starts where the straight run's is
    return {
        "data": {"dataset": "synthetic", "num_classes": 4, "crop_size": CROP,
                 "synthetic_canvas": CROP, "synthetic_size": 4, "split": "full",
                 "num_workers": 1},
        "model": {"backbone": "resnet18", "decoder": "unet", "output_stride": 32,
                  "compute_dtype": "float32"},
        "method": {"name": method, "rampup_iters": 3, "ema_alpha": 0.9},
        "optim": {"lr": 0.05},
        "train": {"labeled_batch_size": 2, "unlabeled_batch_size": 2, "eval_batch_size": 4,
                  "epochs": 3, "log_interval": 1, "async_checkpoint": False,
                  "work_dir": str(work_dir), **train},
    }


def _state(seed=0, method=supervised):
    cfg = config.config_from_dict(_raw("unused"))
    return method.init_state(cfg, build_model(cfg, seed=seed), 10)


def _named(state):
    """Every tensor of a train state, by name, plus the step."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.ema_model is not None:
        out.update({f"ema.{k}": v for k, v in state.ema_model.state_dict().items()})
    out.update({f"momentum.{k}": v for k, v in compat._named_buffers(state).items()})
    return out, state.step


def _assert_states_equal(a, b):
    (ta, sa), (tb, sb) = _named(a), _named(b)
    assert sa == sb and set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_slot_layout_max_to_keep_and_best_slot(tmp_path):
    trainer = Trainer(config.config_from_dict(_raw(tmp_path, keep_checkpoints=2)), device="cpu")
    best = trainer.fit()
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    ipe = trainer.iters_per_epoch
    assert mgr.steps() == [2 * ipe, 3 * ipe]  # one per epoch, the newest two kept
    for step in mgr.steps():
        slot = tmp_path / "checkpoints" / str(step)
        assert sorted(os.listdir(slot)) == ["checkpoint.pth", "meta.json", "rng.pth"]
        meta = json.loads((slot / "meta.json").read_text())
        assert set(meta) == {"epoch", "best_miou", "miou", "config"}
        assert meta["epoch"] == step // ipe - 1 and meta["config"]["method"]["name"] == "supervised"
        obj = torch.load(slot / "checkpoint.pth", weights_only=True)
        assert set(obj) == {"model", "optimizer", "epoch", "best_miou", "step"}
        assert obj["step"] == step and obj["epoch"] == meta["epoch"]
    best_mgr = CheckpointManager(str(tmp_path / "checkpoints_best"))
    assert len(best_mgr.steps()) == 1
    best_meta = json.loads((tmp_path / "checkpoints_best" / str(best_mgr.latest_step())
                            / "meta.json").read_text())
    assert best_meta["best_miou"] == best_meta["miou"] == best > 0
    # the last slot's state is the trainer's
    restored = _state(seed=1)
    meta = mgr.restore(restored)
    assert meta["epoch"] == 2
    _assert_states_equal(restored, trainer.state)


def test_async_save_joins_at_wait_and_raises_its_error(tmp_path, monkeypatch):
    state = _state()
    real_save, threads = torch.save, []

    def spy(obj, path, *a, **k):
        threads.append(threading.current_thread())
        return real_save(obj, path, *a, **k)

    monkeypatch.setattr(torch, "save", spy)
    mgr = CheckpointManager(str(tmp_path / "a"), async_save=True)
    mgr.save(3, state, {"epoch": 0})
    # the state may move on at once: the slot holds the copy made in save()
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 3 and threads
    assert all(t is not threading.main_thread() for t in threads)
    back = _state(seed=2)
    mgr.restore(back)
    p0 = next(iter(back.model.parameters()))
    assert torch.equal(p0 + 1.0, next(iter(state.model.parameters())))

    def boom(obj, path, *a, **k):
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", boom)
    bad = CheckpointManager(str(tmp_path / "b"), async_save=True)
    bad.save(5, state, {"epoch": 0})  # returns: the write runs on the thread
    with pytest.raises(RuntimeError, match="no space left on device"):
        bad.wait()
    assert bad.latest_step() is None
    bad.wait()  # the error is raised once


def test_half_written_slot_is_never_the_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    state.step = 4
    mgr.save(4, state, {"epoch": 1})
    mgr.wait()
    # a crash mid-write: the temporary directory of step 8, and a slot of
    # step 9 without its meta file (written last, before the rename)
    (tmp_path / ".8.tmp").mkdir()
    (tmp_path / ".8.tmp" / "checkpoint.pth").write_bytes(b"partial")
    (tmp_path / "9").mkdir()
    (tmp_path / "9" / "checkpoint.pth").write_bytes(b"partial")
    assert mgr.steps() == [4] and mgr.latest_step() == 4
    back = _state(seed=3)
    assert mgr.restore(back) == {"epoch": 1} and back.step == 4
    with pytest.raises(FileNotFoundError, match="step 9"):
        mgr.restore(back, 9)


def test_dir_step_in_resume_and_in_the_eval_loader(tmp_path):
    assert parse_checkpoint_arg("runs/x/checkpoints") == ("runs/x/checkpoints", None)
    assert parse_checkpoint_arg("runs/x/checkpoints:12") == ("runs/x/checkpoints", 12)
    assert parse_checkpoint_arg("C:/runs/ckpt") == ("C:/runs/ckpt", None)
    first = Trainer(config.config_from_dict(_raw(tmp_path / "a", epochs=2)), device="cpu")
    first.fit()
    ipe = first.iters_per_epoch
    ckpt_dir = str(tmp_path / "a" / "checkpoints")
    assert CheckpointManager(ckpt_dir).steps() == [ipe, 2 * ipe]
    # resume from the older slot of another run's directory
    second = Trainer(config.config_from_dict(_raw(tmp_path / "b", epochs=2,
                                                  resume=f"{ckpt_dir}:{ipe}")), device="cpu")
    try:
        assert second.start_epoch == 1 and second.state.step == ipe
    finally:
        second.close()
    cfg = config.config_from_dict(_raw(tmp_path / "a"))
    latest, _, meta = port_eval_cli.load_state(cfg, ckpt_dir, "cpu")
    assert meta["epoch"] == 1 and latest.step == 2 * ipe
    _assert_states_equal(latest, first.state)
    older, _, meta = port_eval_cli.load_state(cfg, f"{ckpt_dir}:{ipe}", "cpu")
    assert meta["epoch"] == 0 and older.step == ipe


def test_restore_into_another_model_names_the_keys(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(), {"epoch": 0})
    cfg = config.config_from_dict({"data": {"dataset": "synthetic", "num_classes": 4},
                                   "model": {"backbone": "hrnet_w48", "decoder": "hrnet_head",
                                             "hrnet_width": 8, "hrnet_modules": [1, 1, 1]}})
    other = supervised.init_state(cfg, build_model(cfg), 10)
    with pytest.raises(RuntimeError, match=r"missing keys \['decoder\.fuse0\.bias'.*"
                                           r"unexpected keys \['decoder\.up0\.conv1\.Conv_0\.weight'"):
        mgr.restore(other)
    from semi_supervised_semantic_segmentation_tpu_torch.methods import mean_teacher

    with pytest.raises(RuntimeError, match="'ema_model' is in the state only"):
        mgr.restore(_state(method=mean_teacher))


def test_slot_loads_in_the_reference(tmp_path):
    state = _state()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for b in compat._named_buffers(state).values():
            b.copy_(torch.randn(b.shape, generator=g))
    state.step = 7
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, {"epoch": 2, "best_miou": 0.5})
    mgr.wait()
    jcfg = jconfig.config_from_dict(_raw("unused"))
    template = jax.device_get(jsupervised.init_state(jcfg, jbuild(jcfg), jax.random.key(9), 10))
    restored = jax.device_get(jcompat.import_reference_checkpoint(
        str(tmp_path / "7" / checkpoint.CKPT_FILE), template))
    assert int(restored.step) == 7
    _assert_flat_equal(_jax_flat(restored.params, restored.batch_stats),
                       {k: v.numpy() for k, v in state.model.state_dict().items()})
    _assert_flat_equal(_jax_momentum(restored),
                       {k: v.numpy() for k, v in compat._named_buffers(state).items()})


class _Preempted(Exception):
    pass


@pytest.mark.parametrize("method", ["supervised", "mean_teacher"])
def test_resume_equals_an_uninterrupted_run_bitwise(tmp_path, method):
    """N = 3 epochs straight against K = 1 epoch, a preemption at the start
    of epoch 1 (the rolling slot of epoch 0 on its thread), a new Trainer
    with ``train.resume=auto`` and the 2 epochs left."""
    n, k = 3, 1
    straight = Trainer(config.config_from_dict(_raw(tmp_path / "straight", method)),
                       device="cpu")
    best_straight = straight.fit()

    raw = _raw(tmp_path / "resumed", method, async_checkpoint=True)
    first = Trainer(config.config_from_dict(raw), device="cpu")
    run_epoch = first.train_epoch

    def preempted_at_k(epoch):
        if epoch == k:
            raise _Preempted
        return run_epoch(epoch)

    first.train_epoch = preempted_at_k
    with pytest.raises(_Preempted):
        first.fit()
    ipe = first.iters_per_epoch
    assert CheckpointManager(str(tmp_path / "resumed" / "checkpoints")).steps() == [k * ipe]

    second = Trainer(config.config_from_dict({**raw, "train": {**raw["train"],
                                                               "resume": "auto"}}),
                     device="cpu")
    assert second.start_epoch == k and second.state.step == k * ipe
    assert second.best_miou == first.best_miou > 0
    best_resumed = second.fit()
    assert second.state.step == straight.state.step == n * ipe
    _assert_states_equal(second.state, straight.state)
    if method == "mean_teacher":
        assert second.state.ema_model is not None
    assert best_resumed == best_straight
    assert second.last == {**straight.last, "images_per_sec": second.last["images_per_sec"]}
    records = [json.loads(line) for line in
               (tmp_path / "resumed" / "metrics.jsonl").read_text().splitlines()]
    steps = [r["train"]["step"] for r in records if "train" in r]
    assert steps == list(range(n * ipe))  # epoch 0's, then the resumed run's
