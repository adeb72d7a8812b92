"""The port's data-parallel step as a whole, on two CPU ranks joined by gloo
(``tests/torch_ddp_workers.py``): each rank holds its row block of the
global batch, and the step must be the one-process step on the gathered
batch (``tests/test_parallel.py::test_dp_step_equals_single_device_step``
is the reference's counterpart).

- One step of each method from its seeded weights, with the step's own
  draws (every rank draws the global batch's and keeps its rows), with the
  nets in float64: supervised and Mean Teacher on U-Net/ResNet-18;
  FixMatch + CutMix on ResNet-18 + DeepLabV3+ (ASPP dropout, ``stem_impl``
  and ``cutmix_impl`` pallas: kernels B, C and A's plain versions, A's
  partner row from the other rank) and on a width-8 HRNet (config 5's
  ``branch_conv: pallas``, remat ``stages:3`` and OHEM: D and E's plain
  versions under the mesh); CPS in both forms (``separate``, ``stacked``
  under ``torch.func.vmap``) on ResNet-18 + DeepLabV3+ with OHEM.  A
  random-init net is chaotic in its gradients (ROADMAP Queue 3 item 5), so
  every net's gradient is compared as one vector, and so are the
  parameters after the update, the BatchNorm running statistics and the EMA
  teacher: relative distance <= 1e-5; the step's scalars within rtol 1e-5;
  the two ranks end bit-equal.  Why float64: in float32 the one-process
  step itself sits 4e-3 (supervised, batch 8) to 6e-3 (Mean Teacher) from
  its float64 value (the gradient through BatchNorm over a few pixels
  cancels), which is also how far ``F.batch_norm`` and the one-pass SyncBN
  land apart; in float64 the forms agree to 1e-14 and only a misplaced
  reduction shows (``tests/test_torch_cps.py`` does the same).  Where a
  plain version rounds to bf16 by contract (the stem's folded BatchNorm
  (f32), D's input transform and E's dY (bf16) in the HRNet case) the
  limit of that case is the distance of a control: the one-process step
  against itself with its f32 weights scaled by 1 + 1e-7 N(0, 1), measured
  in the test.
- One supervised step on two ranks against the JAX package's step on a
  2-device mesh (GSPMD), from the reference's weights, with the
  reference's scale-crop-flip draws replayed (as
  ``tests/test_torch_real_data_step.py``): the tolerances of
  ``tests/torch_port_helpers.py::steps_against_jax``.
- ``Trainer.fit`` on two ranks: the eval's confusion matrix equals one
  process's, rank 0 alone writes ``config.yaml``, ``train.log``,
  ``metrics.jsonl`` (one record per log step) and the checkpoints, and a
  slot written by two ranks restores in one process bit-equal, and the
  other way round.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.methods import supervised as jsupervised
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu.parallel import mesh as jmesh
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat, evaluator
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment
from tests.torch_ddp_workers import asdict_weak, ddp_steps, fit, replayed_step, resume, run_ranks
from tests.torch_port_helpers import flat_state, one_torch_thread

R, CROP, NCLS = 2, 64, 5
LIMIT = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _raw(method: str, backbone="resnet18", decoder="unet", **over) -> dict:
    raw = {
        "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP,
                 "scale_min": 0.5, "scale_max": 2.0, "hflip_prob": 0.5, "num_workers": 1},
        "model": {"backbone": backbone, "decoder": decoder, "output_stride": 16,
                  "compute_dtype": "float32"},
        "method": {"name": method},
        "optim": {"lr": 0.01, "weight_decay": 1e-4},
        "train": {"labeled_batch_size": 2 * R, "unlabeled_batch_size": 2 * R, "seed": 3},
    }
    if decoder == "unet":
        raw["model"]["output_stride"] = 32
    for dotted, v in over.items():
        sec, key = dotted.split(".")
        raw[sec][key] = v
    return raw


def _batch(n: int, canvas: int, seed: int, labeled: bool) -> dict:
    """n uint8 canvases with content of random sizes (padding beyond)."""
    rng = np.random.RandomState(seed)
    image = (rng.rand(n, canvas, canvas, 3) * 255).astype(np.uint8)
    label = rng.randint(0, NCLS, (n, canvas, canvas)).astype(np.int32)
    label[rng.rand(n, canvas, canvas) < 0.1] = 255
    if not labeled:
        label[:] = 255
    size = rng.randint(canvas * 3 // 4, canvas + 1, (n, 2)).astype(np.int32)
    return {"image": image, "label": label, "size": size}


HRNET = {"model.hrnet_width": 8, "model.hrnet_modules": [1, 1, 1], "model.branch_conv": "pallas",
         "model.remat": "stages:3", "method.sup_loss": "ohem", "method.ohem_min_kept": 2000,
         "method.ohem_thresh": 0.1, "method.conf_thresh": 0.3,
         "data.crop_size": 128, "data.cutmix_impl": "pallas"}
CASES = {
    "supervised": _raw("supervised", **{"model.stem_impl": "pallas"}),
    "mean_teacher": _raw("mean_teacher", **{"method.consistency_reduction": "classes"}),
    "fixmatch_dlv3p": _raw("fixmatch_cutmix", decoder="deeplabv3plus",
                           **{"model.stem_impl": "pallas", "data.cutmix_impl": "pallas",
                              "method.conf_thresh": 0.3}),
    "fixmatch_hrnet": _raw("fixmatch_cutmix", "hrnet_w48", "hrnet_head", **HRNET),
    "cps_separate": _raw("cps", decoder="deeplabv3plus",
                         **{"method.sup_loss": "ohem", "method.ohem_min_kept": 3000,
                            "method.ohem_thresh": 0.1}),
    "cps_stacked": _raw("cps", decoder="deeplabv3plus",
                        **{"method.sup_loss": "ohem", "method.ohem_min_kept": 3000,
                           "method.ohem_thresh": 0.1, "method.cps_impl": "stacked"}),
}


def _case_batches(raw: dict):
    canvas = raw["data"]["crop_size"] + 16
    lab = _batch(raw["train"]["labeled_batch_size"], canvas, 1, True)
    needs_unlab = raw["method"]["name"] != "supervised"
    return lab, _batch(raw["train"]["unlabeled_batch_size"], canvas, 2, False) \
        if needs_unlab else None


# the cases whose plain versions round to bf16 by contract: limit from a control
CONTROLLED = ("fixmatch_hrnet",)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{case: the ranks' results}: one spawn (rank 0 also runs the
    one-process step on the whole batch)."""
    cases = [(raw, *_case_batches(raw), name in CONTROLLED) for name, raw in CASES.items()]
    ranks = run_ranks(ddp_steps, R, str(tmp_path_factory.mktemp("steps")), cases)
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_equals_one_process_step(steps, name):
    ranks = steps[name]
    r0 = ranks[0]
    assert r0["collectives"] > 0 and r0["collectives"] == ranks[1]["collectives"]
    assert r0["ref_collectives"] == 0  # one process: no collective launched
    assert r0["digest"] == ranks[1]["digest"]  # the ranks end bit-equal
    for key, rel in r0["rel"].items():
        limit = LIMIT if name not in CONTROLLED else max(LIMIT, r0["control_rel"][key])
        assert rel <= limit, f"{name} {key}: relative distance {rel:.3g} > {limit:.3g}"
    for k, v in r0["ref_metrics"].items():
        assert r0["metrics"][k] == ranks[1]["metrics"][k], k
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=LIMIT, atol=1e-7, err_msg=k)
    assert np.isfinite(r0["ref_metrics"]["loss"]) and r0["ref_metrics"]["loss"] > 0


def test_fixmatch_mask_ratio_is_global(steps):
    ranks = steps["fixmatch_dlv3p"]
    assert 0.0 < ranks[0]["ref_metrics"]["mask_ratio"] < 1.0


# ---------------------------------------------------------------------------
# against the JAX package's step on a 2-device mesh
# ---------------------------------------------------------------------------


def _replay_weak(key, sizes, d) -> augment.WeakParams:
    """The reference's ``weak_augment_batch`` draws under ``key`` as the
    port's ``WeakParams`` (``tests/test_torch_real_data_step.py``)."""
    s, oy, ox, flip = [], [], [], []
    for k, (h, w) in zip(jax.random.split(key, len(sizes)), sizes):
        ks, koy, kox, kf = jax.random.split(k, 4)
        sc = jax.random.uniform(ks, (), minval=d["scale_min"], maxval=d["scale_max"])
        sh = jnp.maximum(jnp.round(h * sc), 1.0)
        sw = jnp.maximum(jnp.round(w * sc), 1.0)
        s.append(float(sc))
        oy.append(float(jnp.floor(jax.random.uniform(koy, ()) * (jnp.maximum(sh - CROP, 0.0) + 1))))
        ox.append(float(jnp.floor(jax.random.uniform(kox, ()) * (jnp.maximum(sw - CROP, 0.0) + 1))))
        flip.append(bool(jax.random.uniform(kf, ()) < d["hflip_prob"]))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return augment.WeakParams(scale=f32(s), oy=f32(oy), ox=f32(ox), flip=torch.tensor(flip))


def test_two_rank_step_equals_the_reference_step_on_a_two_device_mesh(tmp_path):
    raw = _raw("supervised", **{"optim.lr": 0.05})
    raw["train"]["labeled_batch_size"] = 4
    lab = _batch(4, CROP + 16, 5, True)
    jcfg = jconfig.config_from_dict(raw)
    jmodel = jbuild(jcfg)
    jstate = jsupervised.init_state(jcfg, jmodel, jax.random.key(0), 1)
    key = jax.random.fold_in(jax.random.wrap_key_data(jstate.rng), jstate.step)
    weak = _replay_weak(jax.random.split(key)[0], lab["size"], raw["data"])
    assert weak.flip.any() and not weak.flip.all()
    model = build_model(config.config_from_dict(raw))
    compat.load_flax_variables(model, jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    before = flat_state(jstate.params, {})
    mesh = jmesh.make_mesh(data_parallel=R)
    jstate, jm = jax.jit(jsupervised.make_train_step(jcfg, jmodel, 1))(
        jmesh.replicate(jstate, mesh),
        jmesh.shard_batch({k: jnp.asarray(v) for k, v in lab.items()}, mesh))
    outs = run_ranks(replayed_step, R, str(tmp_path / "ranks"), raw, model.state_dict(), lab,
                     asdict_weak(weak))
    for o in outs:
        np.testing.assert_allclose([o["metrics"][k] for k in ("loss", "sup_loss")],
                                   [float(jm[k]) for k in ("loss", "sup_loss")],
                                   rtol=2e-3, atol=2e-3)
        assert abs(o["metrics"]["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    got = outs[0]["state"]
    assert all(torch.equal(got[k], outs[1]["state"][k]) for k in got)
    for k, v in flat_state(jstate.params, jstate.batch_stats).items():
        g = got[k].numpy()
        if "running_" in k:
            np.testing.assert_allclose(g, v, rtol=1e-3, atol=1e-3 * np.abs(v).max(), err_msg=k)
            continue
        want = v - before[k]
        err = np.linalg.norm((g - before[k]) - want)
        assert err <= 0.15 * np.linalg.norm(want) + 1e-7 * np.linalg.norm(v), k


# ---------------------------------------------------------------------------
# the trainer on two ranks
# ---------------------------------------------------------------------------


def _fit_raw(work: str, **train) -> dict:
    raw = _raw("supervised", **{"model.stem_impl": "pallas"})
    raw["data"].update({"synthetic_size": 8, "synthetic_canvas": 96})
    raw["train"].update({"epochs": 1, "iters_per_epoch": 2, "log_interval": 1,
                         "eval_batch_size": 4, "work_dir": work, "async_checkpoint": False,
                         **train})
    return raw


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("fit2"))
    raw = _fit_raw(work)
    return work, raw, run_ranks(fit, R, os.path.join(work, "ranks"), raw)


def test_two_rank_fit_writes_the_run_files_once(fitted):
    work, raw, outs = fitted
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["mesh"] == {"data": R, "model": 1} and o["val_rows"] == 2 for o in outs)
    with open(os.path.join(work, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["train"]["step"] for r in recs if "train" in r] == [0, 1]
    assert [r["val"]["step"] for r in recs if "val" in r] == [0]
    assert os.path.isfile(os.path.join(work, "config.yaml"))
    assert os.path.isfile(os.path.join(work, "train.log"))
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == ["2"]
    assert outs[0]["state"] == outs[1]["state"]  # bit-equal ranks


def test_two_rank_eval_equals_one_process_eval(fitted):
    """The 2-rank pass's confusion matrix (each rank its rows of every val
    batch, summed over ranks) against one process's on the same weights."""
    work, raw, outs = fitted
    cfg = config.config_from_dict(raw)
    from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval

    state, method, _ = port_eval.load_state(cfg, os.path.join(work, "checkpoints"), "cpu")
    loader = evaluator.val_loader(cfg)
    try:
        cm = evaluator.eval_confusion(evaluator.make_evaluator(cfg),
                                      evaluator.inference_model(state, method), loader, "cpu")
    finally:
        loader.close()
    assert cm.sum() == outs[0]["cm"].sum() > 0
    np.testing.assert_array_equal(outs[0]["cm"], cm)
    np.testing.assert_array_equal(outs[1]["cm"], cm)


def test_slot_of_two_ranks_restores_in_one_process(fitted):
    work, raw, outs = fitted
    got = resume(0, 1, {**raw, "train": {**raw["train"], "resume": "auto", "epochs": 2}})
    assert got["step"] == outs[0]["step"] == 2 and got["start_epoch"] == 1
    for key in ("params", "buffers", "momentum"):
        assert got["state"][key] == outs[0]["state"][key], key


def test_slot_of_one_process_restores_on_two_ranks(tmp_path):
    work = str(tmp_path / "fit1")
    raw = _fit_raw(work, eval_interval=5)
    one = fit(0, 1, raw)
    outs = run_ranks(resume, R, str(tmp_path / "ranks"),
                     {**raw, "train": {**raw["train"], "resume": "auto", "epochs": 2}})
    for o in outs:
        assert o["step"] == one["step"] == 2 and o["start_epoch"] == 1
        for key in ("params", "buffers", "momentum"):
            assert o["state"][key] == one["state"][key], key
