"""CPS's two-net state through the port's checkpoints, against the JAX
package (U-Net/ResNet-18 at crop 32, float32):

- a JAX CPS state after two steps, written by the reference's
  ``export_reference_checkpoint`` (``model`` and ``model2``, four param
  groups, momentum indexed over both nets), loads into the port through the
  eval entry point's loader: both nets and both nets' momentum equal
  (exactly); the port's export of a state with its own momentum loads into
  the reference's ``import_reference_checkpoint`` equal (exactly), with
  the reference's param groups;
- a CPS run resumed through the checkpoint manager (``train.resume=auto``
  after a preemption) equals the uninterrupted run bit for bit: both nets,
  both nets' momentum, step, best mIoU and the last train scalars; a slot
  of one net is refused;
- the eval entry point (``--device cpu``) scores net1 of the reference's
  file with the reference's confusion matrix on the same weights.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.methods import cps as jcps
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval_cli
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat, evaluator
from semi_supervised_semantic_segmentation_tpu_torch.engine.checkpoint import CheckpointManager
from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer
from semi_supervised_semantic_segmentation_tpu_torch.methods import supervised
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.ops.metrics import iou_from_confusion
from tests.test_torch_checkpoint import _assert_flat_equal, _jax_flat, _jax_momentum
from tests.test_torch_checkpoint_manager import _Preempted, _raw
from tests.test_torch_evaluator import assert_confusion_agrees, jax_eval
from tests.torch_port_helpers import one_torch_thread, uint8_batches

CROP, NCLS, STEPS = 32, 4, 2
RAW = {
    "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP,
             "synthetic_size": 8, "num_workers": 1},
    "model": {"backbone": "resnet18", "decoder": "unet", "output_stride": 32,
              "compute_dtype": "float32"},
    "method": {"name": "cps", "cps_impl": "separate"},
    "optim": {"lr": 0.05, "weight_decay": 5e-4},
    "train": {"labeled_batch_size": 2, "unlabeled_batch_size": 2, "eval_batch_size": 8,
              "epochs": 1},
}


@pytest.fixture(autouse=True)
def _one_torch_thread(tmp_path):
    with one_torch_thread():
        yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_trained():
    """(config, reference model, reference CPS state after 2 steps)."""
    jcfg = jconfig.config_from_dict(RAW)
    jmodel = jbuild(jcfg)
    jstate = jcps.init_state(jcfg, jmodel, jax.random.key(0), 10)
    jstep = jax.jit(jcps.make_train_step(jcfg, jmodel, 10))
    lab = uint8_batches(STEPS, 2, CROP, NCLS, 0, True)
    unlab = uint8_batches(STEPS, 2, CROP, NCLS, 1, False)
    for i in range(STEPS):
        jstate, _ = jstep(jstate, lab[i], unlab[i])
    return jcfg, jmodel, jax.device_get(jstate)


def _nets(state):
    return {f"net{i}.{k}": v.numpy() for i, net in ((1, state.model), (2, state.model2))
            for k, v in net.state_dict().items()}


def _momentum(state):
    return {f"net{i}.{k}": v.numpy() for i, net in ((1, state.model), (2, state.model2))
            for k, v in compat._named_buffers(state, net).items()}


def _jax_nets(params, stats):
    return {f"{n}.{k}": v for n in ("net1", "net2")
            for k, v in _jax_flat(params[n], stats[n]).items()}


def test_reference_checkpoint_loads_into_the_port(jax_trained, tmp_path):
    jcfg, _, jstate = jax_trained
    path = str(tmp_path / "ref.pth")
    jcompat.export_reference_checkpoint(path, jstate, {"epoch": 3, "best_miou": 0.125}, cfg=jcfg)
    obj = torch.load(path, weights_only=True)
    assert set(obj) == {"model", "model2", "optimizer", "epoch", "best_miou", "step"}
    assert len(obj["optimizer"]["param_groups"]) == 4
    state, method, meta = port_eval_cli.load_state(config.config_from_dict(RAW), path, "cpu")
    assert meta == {"epoch": 3, "best_miou": 0.125} and state.step == STEPS
    assert state.ema_model is None and evaluator.inference_model(state, method) is state.model
    _assert_flat_equal(_nets(state), _jax_nets(jstate.params, jstate.batch_stats))
    want = _jax_momentum(jstate)
    assert all(np.abs(want[f"{n}.decoder.head.weight"]).max() > 0 for n in ("net1", "net2"))
    _assert_flat_equal(_momentum(state), want)


def test_port_checkpoint_loads_into_the_reference(jax_trained, tmp_path):
    jcfg, _, jstate = jax_trained
    cfg = config.config_from_dict(RAW)
    src = str(tmp_path / "ref.pth")
    jcompat.export_reference_checkpoint(src, jstate, {}, cfg=jcfg)
    state, _, _ = port_eval_cli.load_state(cfg, src, "cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for net in state.nets():
            for b in compat._named_buffers(state, net).values():
                b.copy_(torch.randn(b.shape, generator=g))
        for t in state.model2.state_dict().values():
            t.add_(0.01 * torch.randn(t.shape, generator=g))
    state.step = 7
    path = str(tmp_path / "port.pth")
    compat.export_reference_checkpoint(path, state, {"epoch": 2, "best_miou": 0.5}, cfg)
    obj = torch.load(path, weights_only=True)
    assert set(obj) == {"model", "model2", "optimizer", "epoch", "best_miou", "step"}
    assert obj["optimizer"]["param_groups"] == \
        jcompat.export_optimizer_state(jstate, jcfg)["param_groups"]

    moved = lambda t: jax.tree.map(lambda a: np.asarray(a) + 1.0, t)  # noqa: E731
    template = jstate.replace(params=moved(jstate.params), batch_stats=moved(jstate.batch_stats))
    restored = jax.device_get(jcompat.import_reference_checkpoint(path, template))
    assert int(restored.step) == 7
    _assert_flat_equal(_jax_nets(restored.params, restored.batch_stats), _nets(state))
    _assert_flat_equal(_jax_momentum(restored), _momentum(state))


def _named(state):
    out = {f"net{i}.{k}": v for i, net in ((1, state.model), (2, state.model2))
           for k, v in net.state_dict().items()}
    out.update({f"momentum{i}.{k}": v for i, net in ((1, state.model), (2, state.model2))
                for k, v in compat._named_buffers(state, net).items()})
    return out


def test_cps_resume_equals_an_uninterrupted_run_bitwise(tmp_path):
    n, k = 3, 1
    straight = Trainer(config.config_from_dict(_raw(tmp_path / "straight", "cps")), device="cpu")
    best_straight = straight.fit()

    raw = _raw(tmp_path / "resumed", "cps", async_checkpoint=True)
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
    slot = tmp_path / "resumed" / "checkpoints"
    assert CheckpointManager(str(slot)).steps() == [k * ipe]
    assert "model2" in torch.load(str(slot / str(k * ipe) / "checkpoint.pth"), weights_only=True)

    # a supervised state (one net) is refused by the two-net slot
    cfg1 = config.config_from_dict(_raw("unused"))
    with pytest.raises(RuntimeError, match="'model2' is in the slot only"):
        CheckpointManager(str(slot)).restore(supervised.init_state(cfg1, build_model(cfg1), 10))

    second = Trainer(config.config_from_dict({**raw, "train": {**raw["train"],
                                                               "resume": "auto"}}),
                     device="cpu")
    assert second.start_epoch == k and second.state.step == k * ipe
    best_resumed = second.fit()
    assert second.state.step == straight.state.step == n * ipe
    a, b = _named(second.state), _named(straight.state)
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert best_resumed == best_straight
    assert second.last == {**straight.last, "images_per_sec": second.last["images_per_sec"]}
    assert {"loss", "sup_loss", "cps_loss", "lr"} <= set(second.last)


def test_eval_entry_point_scores_net1_as_the_reference(jax_trained, tmp_path, monkeypatch):
    jcfg, jmodel, jstate = jax_trained
    ckpt = str(tmp_path / "ref.pth")
    jcompat.export_reference_checkpoint(ckpt, jstate, {"epoch": 1}, cfg=jcfg)
    cfg_path = str(tmp_path / "config.yaml")
    config.save_config(config.config_from_dict(RAW), cfg_path)
    iou, miou, _ = port_eval_cli.main(["--config", cfg_path, "--checkpoint", ckpt,
                                       "--device", "cpu"])

    cfg = config.config_from_dict(RAW)
    loader = evaluator.val_loader(cfg)
    batch = next(iter(loader.epoch(0)))
    loader.close()
    assert len(loader.dataset) == 8  # one val batch
    cm_ref, prob_ref = jax_eval(RAW, jmodel, jstate.params["net1"], jstate.batch_stats["net1"],
                                {k: batch[k] for k in ("image", "label")}, monkeypatch)
    state, method, _ = port_eval_cli.load_state(cfg, ckpt, "cpu")
    model = evaluator.inference_model(state, method)
    assert model is state.model
    model.eval()
    tb = {k: torch.from_numpy(batch[k]) for k in ("image", "label")}
    with torch.no_grad():
        cm = evaluator.make_evaluator(cfg)(model, tb).numpy()
        prob = evaluator.make_probs(cfg)(model, tb).permute(0, 2, 3, 1).numpy()
    assert_confusion_agrees(cm, cm_ref, prob, prob_ref, batch["label"], NCLS)
    np.testing.assert_array_equal(cm, cm_ref)
    ref_iou, ref_miou = iou_from_confusion(cm_ref)[:2]
    np.testing.assert_array_equal(np.asarray(iou), np.asarray(ref_iou))
    assert miou == ref_miou
    # net2 scores differently: the entry point did not read it
    with torch.no_grad():
        cm2 = evaluator.make_evaluator(cfg)(state.model2.eval(), tb).numpy()
    assert not np.array_equal(cm2, cm)
    assert os.path.isfile(ckpt)
