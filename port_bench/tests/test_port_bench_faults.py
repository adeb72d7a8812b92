"""The harness's check on the CPU at tiny sizes: sound runs of the program
come out correct, and runs with the timed path broken underneath (the
look for a card skipped) come out not correct, once for each fault a cell
can have: a step that leaves the state unchanged, half of the batch left
out with the mean over the rest, and an answer altered where it is
produced (a training step's gradient of one leaf, or its teacher's
pseudo-labels; an eval batch's predictions).  The run uses the tiny cells
of :mod:`port_bench.tests.tiny` (float32, so that the program and the
reference agree to rounding), and the control, the reference in float8 in
the program's place, fails them too."""

from __future__ import annotations

import pytest
import torch

from port_bench import checks
from port_bench.bench import Benchmark
from port_bench.control import eval_controls, train_controls
from port_bench.run import result, run_cell
from port_bench.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(4)
    return Benchmark(tiny.make_root(str(tmp_path_factory.mktemp("bench"))))


def _run(bench, cell):
    run = run_cell(bench, cell, 2 ** 31 + 11, 0.3, False, "cpu", 0.0)
    return result(run)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(bench, cell):
    line = _run(bench, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from semi_supervised_semantic_segmentation_tpu_torch.engine import state

    monkeypatch.setattr(state.SGD, "step", lambda self, step, mesh=None: self.lr(step))
    monkeypatch.setattr("semi_supervised_semantic_segmentation_tpu_torch.methods.fixmatch."
                        "ema_update", lambda *a, **k: None)


def _gradient_altered(monkeypatch):
    from semi_supervised_semantic_segmentation_tpu_torch.engine import state

    step = state.SGD.step

    def doubled(self, i, mesh=None):
        p = self.groups[0][0][0]
        p.grad.mul_(2.0)
        return step(self, i, mesh)

    monkeypatch.setattr(state.SGD, "step", doubled)


def _half(fn):
    def wrapped(logits, labels, *args, **kwargs):
        n = max(logits.shape[0] // 2, 1)
        return fn(logits[:n], labels[:n], *args, **kwargs)

    return wrapped


def _half_batch_train(monkeypatch):
    from semi_supervised_semantic_segmentation_tpu_torch.ops import losses

    for name in ("cross_entropy", "ohem_cross_entropy"):
        monkeypatch.setattr(losses, name, _half(getattr(losses, name)))
    masked = losses.confidence_masked_ce

    def half_masked(logits, pseudo, conf, *args, **kwargs):
        n = max(logits.shape[0] // 2, 1)
        return masked(logits[:n], pseudo[:n], conf[:n], *args, **kwargs)

    monkeypatch.setattr(losses, "confidence_masked_ce", half_masked)


def _pseudo_altered(monkeypatch):
    from semi_supervised_semantic_segmentation_tpu_torch.ops import losses

    orig = losses.pseudo_labels_from_logits

    def shifted(logits, thresh):
        labels, conf = orig(logits, thresh)
        return (labels + 1) % logits.shape[1], conf

    monkeypatch.setattr(losses, "pseudo_labels_from_logits", shifted)


def _confusion_patch(monkeypatch, change):
    from semi_supervised_semantic_segmentation_tpu_torch.ops import metrics

    orig = metrics.confusion_matrix

    def patched(pred, label, num_classes, ignore_index=255):
        return orig(*change(pred, label, num_classes), num_classes, ignore_index)

    monkeypatch.setattr(metrics, "confusion_matrix", patched)


def _half_batch_eval(monkeypatch):
    _confusion_patch(monkeypatch, lambda p, l, c: (p[: max(len(p) // 2, 1)],
                                                   l[: max(len(l) // 2, 1)]))


def _prediction_altered(monkeypatch):
    _confusion_patch(monkeypatch, lambda p, l, c: ((p + 1) % c, l))


FAULTS = {
    ("tiny_r50_train", "state_unchanged"): _state_unchanged,
    ("tiny_r50_train", "half_batch"): _half_batch_train,
    ("tiny_r50_train", "gradient_altered"): _gradient_altered,
    ("tiny_hrnet_train", "state_unchanged"): _state_unchanged,
    ("tiny_hrnet_train", "half_batch"): _half_batch_train,
    ("tiny_hrnet_train", "pseudo_label_altered"): _pseudo_altered,
    ("tiny_hrnet_train", "gradient_altered"): _gradient_altered,
    ("tiny_hrnet_eval", "half_batch"): _half_batch_eval,
    ("tiny_hrnet_eval", "prediction_altered"): _prediction_altered,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_makes_run_incorrect(bench, monkeypatch, cell, fault):
    FAULTS[(cell, fault)](monkeypatch)
    line = _run(bench, cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_fails_a_number(bench, cell):
    c = bench.cell(cell)
    controls = train_controls if c.traffic["loop"] == "train" else eval_controls
    for kind, numbers in controls(c, 2 ** 31 + 11, ("fp8",), "cpu"):
        assert not checks.correct(checks.held(numbers, c.limits)), (kind, numbers)


def test_state_unchanged_reads_one():
    ref = {"losses": [1.0, 1.0, 1.0], "grad": {"a": 1.0, "b": 2.0},
           "change": {"a": 0.5, "b": 0.25}}
    still = {**ref, "change": {"a": 0.0, "b": 0.0}}
    assert checks.training_numbers(still, ref)["change_gap"] == 1.0
