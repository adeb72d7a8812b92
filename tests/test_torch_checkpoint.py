"""Checkpoint interchange of the port (``engine/compat.py``, the ``eval``
entry point) against the JAX package:

- a JAX FixMatch state after two steps (width-8 HRNet + HRNetV2 head,
  float32), written by the reference's ``export_reference_checkpoint``,
  loads into the port through the eval entry point's loader: the same
  weights (exactly), the same momentum buffers as the reference's optax
  traces (exactly), and the port's eval gives the reference's confusion
  matrix (equal, or different only in pixels whose top-2 probability margin
  is under the evaluator tests' tolerance);
- the port's export loads back into the reference's
  ``import_reference_checkpoint`` as an equal state (exactly);
- ``model.pretrained``: fabricated torchvision-ResNet-50 and official-HRNet
  state dicts give the same encoder weights through the reference's
  ``load_pretrained_encoder`` and the port's (exactly);
- ``save_predictions``: the port's own PNG writer decodes (PIL) to the same
  indices and palette as the reference's PIL files;
- the ``eval`` entry point on an explicit CPU (IoU table, ``--save_preds``,
  ``--export_torch``, a missing file or checkpoint directory) and
  ``train.init_from_torch``.  Checkpoint directories of the port's own
  manager are tests/test_torch_checkpoint_manager.py's.
"""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.engine import evaluator as jevaluator
from semi_supervised_semantic_segmentation_tpu.engine.state import (
    get_momentum_trees,
    head_label_tree,
)
from semi_supervised_semantic_segmentation_tpu.methods import fixmatch as jfixmatch
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval_cli
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat, evaluator
from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer
from semi_supervised_semantic_segmentation_tpu_torch.methods import fixmatch
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.test_torch_evaluator import assert_confusion_agrees, jax_eval, port_eval
from tests.test_torch_hrnet import JSeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP, NCLS, STEPS = 64, 5, 2
RAW = {
    "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP,
             "synthetic_size": 8, "num_workers": 1, "scale_min": 1.0, "scale_max": 1.0,
             "hflip_prob": 0.0, "jitter_prob": 0.0, "grayscale_prob": 0.0, "blur_prob": 0.0},
    "model": {"backbone": "hrnet_w48", "decoder": "hrnet_head", "compute_dtype": "float32",
              "hrnet_width": 8, "hrnet_modules": [1, 1, 1], "head_fuse": "up_first"},
    "method": {"name": "fixmatch_cutmix", "conf_thresh": 0.3, "ema_alpha": 0.9,
               "cutmix_prob": 1.0},
    "optim": {"lr": 0.05, "weight_decay": 5e-4},
    "train": {"labeled_batch_size": 2, "unlabeled_batch_size": 2, "eval_batch_size": 8,
              "epochs": 1},
}


def _jax_flat(params, stats):
    return jcompat.flatten_params_to_torch_layout(jax.device_get(params), jax.device_get(stats))


def _jax_momentum(jstate):
    """The reference's optax traces, one per parameter, by flat name."""
    params = jax.device_get(jstate.params)
    merged = jcompat._pick_momentum(params, head_label_tree(params),
                                    jax.device_get(get_momentum_trees(jstate.opt_state)))
    return jcompat.flatten_params_to_torch_layout(merged, {})


def _assert_flat_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def jax_trained():
    """(config, reference model, reference state after 2 FixMatch steps)."""
    jcfg = jconfig.config_from_dict(RAW)
    jmodel = JSeg(branch_conv="xla", fuse_order="up_first")
    jstate = jfixmatch.init_state(jcfg, jmodel, jax.random.key(0), 10)
    jstep = jax.jit(jfixmatch.make_train_step(jcfg, jmodel, 10))
    rng = np.random.RandomState(0)
    for _ in range(STEPS):
        lab = {"image": (rng.rand(2, CROP, CROP, 3) * 255).astype(np.uint8),
               "label": rng.randint(0, NCLS, (2, CROP, CROP)).astype(np.int32),
               "size": np.full((2, 2), CROP, np.int32)}
        unlab = {**lab, "image": (rng.rand(2, CROP, CROP, 3) * 255).astype(np.uint8),
                 "label": np.full((2, CROP, CROP), 255, np.int32)}
        jstate, _ = jstep(jstate, lab, unlab)
    return jcfg, jmodel, jax.device_get(jstate)


def test_reference_checkpoint_loads_into_the_port(jax_trained, tmp_path, monkeypatch):
    _, jmodel, jstate = jax_trained
    path = str(tmp_path / "ref.pth")
    jcompat.export_reference_checkpoint(path, jstate, {"epoch": 4, "best_miou": 0.25},
                                        cfg=jconfig.config_from_dict(RAW))
    cfg = config.config_from_dict(RAW)
    state, method, meta = port_eval_cli.load_state(cfg, path, "cpu")
    assert meta == {"epoch": 4, "best_miou": 0.25} and state.step == STEPS
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    _assert_flat_equal(sd, _jax_flat(jstate.params, jstate.batch_stats))
    ema = {k: v.numpy() for k, v in state.ema_model.state_dict().items()}
    _assert_flat_equal(ema, _jax_flat(jstate.ema_params, jstate.ema_batch_stats))
    bufs = {k: v.numpy() for k, v in compat._named_buffers(state).items()}
    want = _jax_momentum(jstate)
    assert any(np.abs(v).max() > 0 for v in want.values())
    _assert_flat_equal(bufs, want)

    # the port's eval of the loaded state against the reference's eval of
    # its own state: the EMA teacher, on the val set (one batch of 8)
    model = evaluator.inference_model(state, method)
    assert model is state.ema_model
    loader = evaluator.val_loader(cfg)
    cm = evaluator.eval_confusion(evaluator.make_evaluator(cfg), model, loader, "cpu")
    batch = next(iter(loader.epoch(0)))
    loader.close()
    cm_ref, prob_ref = jax_eval(RAW, jmodel, jstate.ema_params, jstate.ema_batch_stats,
                                {k: batch[k] for k in ("image", "label")}, monkeypatch)
    cm_probs, prob = port_eval(RAW, model, {k: batch[k] for k in ("image", "label")})
    np.testing.assert_array_equal(cm, cm_probs)
    moved = assert_confusion_agrees(cm, cm_ref, prob, prob_ref, batch["label"], NCLS)
    print(f"confusion matrix over {cm.sum()} pixels; {moved} pixels under the margin moved")


def test_port_checkpoint_loads_into_the_reference(jax_trained, tmp_path):
    jcfg, jmodel, jstate = jax_trained
    cfg = config.config_from_dict(RAW)
    # a port state with its own history: the reference's weights, then
    # momentum and teacher of its own
    src = str(tmp_path / "ref.pth")
    jcompat.export_reference_checkpoint(src, jstate, {}, cfg=jcfg)
    state, _, _ = port_eval_cli.load_state(cfg, src, "cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for b in compat._named_buffers(state).values():
            b.copy_(torch.randn(b.shape, generator=g))
        for t in state.ema_model.state_dict().values():
            t.add_(0.01 * torch.randn(t.shape, generator=g))
    state.step = 7
    path = str(tmp_path / "port.pth")
    compat.export_reference_checkpoint(path, state, {"epoch": 2, "best_miou": 0.5}, cfg)
    obj = torch.load(path, weights_only=True)
    assert set(obj) == {"model", "ema_model", "optimizer", "epoch", "best_miou", "step"}
    ref_layout = jcompat.export_optimizer_state(jstate, jcfg)["param_groups"]
    assert [{k: v for k, v in g_.items()} for g_ in obj["optimizer"]["param_groups"]] == ref_layout

    # a template whose weights differ everywhere from the file's
    moved = lambda t: jax.tree.map(lambda a: np.asarray(a) + 1.0, t)  # noqa: E731
    template = jstate.replace(params=moved(jstate.params), ema_params=moved(jstate.ema_params),
                              batch_stats=moved(jstate.batch_stats))
    restored = jax.device_get(jcompat.import_reference_checkpoint(path, template))
    assert int(restored.step) == 7
    _assert_flat_equal(_jax_flat(restored.params, restored.batch_stats),
                       {k: v.numpy() for k, v in state.model.state_dict().items()})
    _assert_flat_equal(_jax_flat(restored.ema_params, restored.ema_batch_stats),
                       {k: v.numpy() for k, v in state.ema_model.state_dict().items()})
    _assert_flat_equal(_jax_momentum(restored),
                       {k: v.numpy() for k, v in compat._named_buffers(state).items()})


# ------------------------------------------------------------ pretrained


def _to_torchvision(name):
    """The port's ResNet-50 encoder name -> torchvision's."""
    name = name.replace(".Norm_0.BatchNorm_0.", ".bn.").replace(".Conv_0.", ".conv.")
    if name.startswith("stem."):
        return name.replace("stem.conv.", "conv1.").replace("stem.bn.", "bn1.")
    m = re.match(r"^layer(\d)_(\d+)\.(conv(\d)|downsample)\.(conv|bn)\.(.+)$", name)
    layer, blk, part, k, kind, leaf = m.groups()
    if part == "downsample":
        return f"layer{layer}.{blk}.downsample.{0 if kind == 'conv' else 1}.{leaf}"
    return f"layer{layer}.{blk}.{kind}{k}.{leaf}"


def _to_official_hrnet(name):
    """The port's HRNet encoder name -> the official HRNet's."""
    name = name.replace(".Norm_0.BatchNorm_0.", ".bn.").replace(".Conv_0.", ".conv.")
    m = re.match(r"^stem(\d)\.(conv|bn)\.(.+)$", name)
    if m:
        return f"{m.group(2)}{m.group(1)}.{m.group(3)}"
    m = re.match(r"^layer1_(\d+)\.(conv(\d)|downsample)\.(conv|bn)\.(.+)$", name)
    if m:
        blk, part, k, kind, leaf = m.groups()
        if part == "downsample":
            return f"layer1.{blk}.downsample.{0 if kind == 'conv' else 1}.{leaf}"
        return f"layer1.{blk}.{kind}{k}.{leaf}"
    m = re.match(r"^transition(\d)_(\d+)\.(conv|bn)\.(.+)$", name)
    if m:
        t, i, kind, leaf = m.groups()
        new_branch = int(i) >= int(t)  # a new branch nests one Sequential more
        return f"transition{t}.{i}.{'0.' if new_branch else ''}{0 if kind == 'conv' else 1}.{leaf}"
    m = re.match(r"^stage(\d)_m(\d+)\.branch(\d+)_block(\d+)\.conv(\d)\.(conv|bn)\.(.+)$", name)
    if m:
        s, mod, i, b, k, kind, leaf = m.groups()
        return f"stage{s}.{mod}.branches.{i}.{b}.{kind}{k}.{leaf}"
    m = re.match(r"^stage(\d)_m(\d+)\.fuse_up_(\d+)_to_(\d+)\.(conv|bn)\.(.+)$", name)
    if m:
        s, mod, j, i, kind, leaf = m.groups()
        return f"stage{s}.{mod}.fuse_layers.{i}.{j}.{0 if kind == 'conv' else 1}.{leaf}"
    m = re.match(r"^stage(\d)_m(\d+)\.fuse_down_(\d+)_to_(\d+)_(\d+)\.(conv|bn)\.(.+)$", name)
    s, mod, j, i, k, kind, leaf = m.groups()
    return f"stage{s}.{mod}.fuse_layers.{i}.{j}.{k}.{0 if kind == 'conv' else 1}.{leaf}"


PRETRAINED = {
    "resnet50": (_to_torchvision, {"fc.weight": (10, 2048), "fc.bias": (10,)}),
    "hrnet_w48": (_to_official_hrnet, {"incre_modules.0.0.conv1.weight": (32, 8, 1, 1),
                                       "classifier.weight": (10, 2048)}),
}


@pytest.mark.parametrize("backbone", sorted(PRETRAINED))
def test_pretrained_encoder_import_matches_the_reference(backbone, tmp_path):
    rename, extra = PRETRAINED[backbone]
    raw = {"data": {"dataset": "synthetic", "num_classes": NCLS},
           "model": ({"backbone": "resnet50", "decoder": "deeplabv3plus"} if backbone == "resnet50"
                     else RAW["model"])}
    raw["model"] = {**raw["model"], "compute_dtype": "float32"}
    fresh = build_model(config.config_from_dict(raw))
    rng = np.random.RandomState(6)
    sd = {rename(k): torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in fresh.encoder.state_dict().items()}
    sd.update({k: torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, s in extra.items()})
    sd.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(3)
               for k in list(sd) if k.endswith("running_var")})
    path = str(tmp_path / f"{backbone}.pth")
    torch.save(sd, path)

    model = build_model(config.config_from_dict({**raw, "model": {**raw["model"],
                                                                  "pretrained": path}}))
    jmodel = jbuild(jconfig.config_from_dict(raw)) if backbone == "resnet50" else JSeg()
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3)), False))
    tmpl = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    params, stats = jcompat.load_pretrained_encoder(path, tmpl["params"], tmpl["batch_stats"])
    want = {f"encoder.{k}": v for k, v in
            _jax_flat(params["encoder"], stats["encoder"]).items()}
    got = {k: v.numpy() for k, v in model.state_dict().items() if k.startswith("encoder.")}
    _assert_flat_equal(got, want)
    # the decoder keeps its seeded initialisation
    for k, v in fresh.decoder.state_dict().items():
        assert torch.equal(model.decoder.state_dict()[k], v), k


# ------------------------------------------------------ predictions, CLI


def test_save_predictions_png_decodes_as_the_reference(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(8)
    preds = rng.randint(0, 21, (3, 40, 48)).astype(np.int32)
    batch = {"index": np.array([0, -1, 2], np.int32),
             "size": np.array([[40, 48], [1, 1], [30, 20]], np.int32)}
    ds = types.SimpleNamespace(ids=["2007_000032", "pad", "city/frankfurt_000001"])
    jevaluator.save_predictions(preds, batch, ds, str(tmp_path / "ref"))
    evaluator.save_predictions(torch.from_numpy(preds), batch, ds, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "2007_000032.png", "city_frankfurt_000001.png"]
    for n in names:
        ref, port = (Image.open(tmp_path / side / n) for side in ("ref", "port"))
        assert port.mode == ref.mode == "P"
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))
        assert port.getpalette() == ref.getpalette()


def _tiny_config3_args(tmp_path):
    return ["--config", os.path.join(REPO, "configs", "3_fixmatch_dlv3p_r50_voc_512.yaml"),
            "--device", "cpu", "--set", "data.dataset=synthetic", "data.crop_size=32",
            "data.synthetic_size=4", "data.num_workers=1", "model.compute_dtype=float32",
            f"train.work_dir={tmp_path}"]


def test_eval_entry_point_on_an_explicit_cpu(tmp_path, capsys):
    """``python -m ...eval --device cpu``: a port checkpoint, the IoU table,
    prediction PNGs and a re-export equal to the file read."""
    args = _tiny_config3_args(tmp_path)
    cfg = config.load_config(args[1], {"data.dataset": "synthetic", "data.crop_size": 32,
                                       "data.synthetic_size": 4, "data.num_workers": 1,
                                       "model.compute_dtype": "float32"})
    state = fixmatch.init_state(cfg, build_model(cfg), 1)
    ckpt = str(tmp_path / "x.pth")
    compat.export_reference_checkpoint(ckpt, state, {"epoch": 1}, cfg)
    out = str(tmp_path / "y.pth")
    iou, miou, acc = port_eval_cli.main(args + ["--checkpoint", ckpt, "--save_preds",
                                                str(tmp_path / "preds"), "--export_torch", out])
    text = capsys.readouterr().out
    assert re.search(r"mIoU: \d\.\d{4}  pixel-acc: \d\.\d{4}", text)
    assert "  class_20 " in text  # the synthetic set's 21 class names
    assert len(os.listdir(tmp_path / "preds")) == 8  # the synthetic val set
    assert 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0 and len(iou) == 21
    a, b = torch.load(ckpt, weights_only=True), torch.load(out, weights_only=True)
    for k in ("model", "ema_model"):
        assert all(torch.equal(a[k][n], b[k][n]) for n in a[k])
    assert b["epoch"] == 1
    with pytest.raises(FileNotFoundError):
        port_eval_cli.main(args + ["--checkpoint", str(tmp_path / "checkpoints:5")])
    with pytest.raises(FileNotFoundError):
        port_eval_cli.main(args + ["--checkpoint", str(tmp_path / "missing.pth")])


def test_trainer_starts_from_a_reference_checkpoint(tmp_path):
    """``train.init_from_torch``: the student, teacher and step of the file."""
    args = _tiny_config3_args(tmp_path)
    over = {"data.dataset": "synthetic", "data.crop_size": 32, "data.synthetic_size": 4,
            "data.num_workers": 1, "model.compute_dtype": "float32",
            "train.work_dir": str(tmp_path)}
    cfg = config.load_config(args[1], over)
    src = fixmatch.init_state(cfg, build_model(cfg, seed=123), 1)
    src.step = 3
    ckpt = str(tmp_path / "x.pth")
    compat.export_reference_checkpoint(ckpt, src, {}, cfg)
    trainer = Trainer(config.load_config(args[1], {**over, "train.init_from_torch": ckpt}),
                      device="cpu")
    try:
        assert trainer.state.step == 3
        for k, v in src.model.state_dict().items():
            assert torch.equal(trainer.state.model.state_dict()[k], v), k
    finally:
        trainer.close()
