"""The port's H-sharded HRNet stem wired into the model, the step and the
trainer, on CPU ranks joined by gloo (``tests/torch_ddp_workers.py``):

- a width-8 HRNet (``stage_modules`` (1, 1, 1), f32) with the spatial stem
  on D = 2 x M = 2 ranks against the JAX package's
  ``HRNet(spatial_mesh=_mesh(2, 2))`` from the same parameters
  (``flatten_params_to_torch_layout``): the taps c2..c5 in eval mode to
  atol 2e-5 (``tests/test_spatial.py``'s tolerance), and in train mode
  with the running statistics it leaves; c1 is left out of the taps under
  a model axis;
- one ``fixmatch_cutmix`` step of a small config-5-shaped model (HRNet,
  OHEM, ``branch_conv: pallas`` through its plain versions, remat
  ``stages:3``) in float64 on D = 1 x M = 2 and D = 2 x M = 2, against one
  process on the whole batch: every vector within 1e-12 (relative), the
  ranks bit-equal (sha256), the halo and gather launches counted;
- ``Trainer.fit`` on D = 1 x M = 2: world rank 0 alone writes the records
  and the slot, the ranks end bit-equal, the val pass's confusion matrix
  is one process's, and the slot restores in one process bit-equal;
- the configuration errors: a model axis on a backbone other than HRNet,
  a world size that is not D x M.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from semi_supervised_semantic_segmentation_tpu.models.hrnet import HRNet as JHRNet
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat, evaluator
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.models.layers import use_mesh
from semi_supervised_semantic_segmentation_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_ddp_workers import ddp_steps, fit, resume, run_ranks, spatial_hrnet
from tests.torch_port_helpers import one_torch_thread

NCLS, CROP = 5, 128
LIMIT = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _jmesh(data: int, model: int) -> JMesh:
    devs = np.asarray(jax.devices()[: data * model]).reshape(data, model)
    return JMesh(devs, ("data", "model"))


# ---------------------------------------------------------------------------
# the spatial HRNet against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hrnet(tmp_path_factory):
    """(reference eval taps, reference train taps and statistics, the four
    ranks' results)."""
    kw = dict(width=8, stage_modules=(1, 1, 1), dtype=jnp.float32)
    plain, sharded = JHRNet(**kw), JHRNet(spatial_mesh=_jmesh(2, 2), **kw)
    rng = np.random.RandomState(4)
    x = rng.rand(4, 64, 64, 3).astype(np.float32)
    variables = plain.init({"params": jax.random.key(0)}, jnp.asarray(x[:1]), train=False)
    ref_eval = sharded.apply(variables, jnp.asarray(x), train=False)
    ref_train, upd = sharded.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    flat = compat.flatten_params_to_torch_layout(jax.device_get(variables["params"]),
                                                 jax.device_get(variables["batch_stats"]))
    stats = compat.flatten_params_to_torch_layout({}, jax.device_get(upd["batch_stats"]))
    outs = run_ranks(spatial_hrnet, 4, str(tmp_path_factory.mktemp("hrnet")), flat, x, 2)
    return ({k: np.asarray(v) for k, v in ref_eval.items()},
            {k: np.asarray(v) for k, v in ref_train.items()}, stats, outs)


def _rows(outs, mode: str, tap: str) -> np.ndarray:
    """The whole batch of a tap, from the data ranks (model rank 0 of each;
    the model ranks' taps are bit-equal)."""
    for r in range(0, 4, 2):
        assert torch.equal(outs[r][mode][tap], outs[r + 1][mode][tap])
    return torch.cat([outs[0][mode][tap], outs[2][mode][tap]]).numpy()


def test_spatial_hrnet_forward_equals_the_reference_spatial_hrnet(hrnet):
    ref_eval, _, _, outs = hrnet
    assert [o["coords"] for o in outs] == [(0, 0, 0), (0, 1, 1), (1, 0, 2), (1, 1, 3)]
    for o in outs:
        assert "c1" not in o["eval"] and "c1" not in o["train"]
        # eval and train forwards: two halo pulls and one gather each
        assert o["counts"]["halo"] == 4 and o["counts"]["gather_h"] == 2
    for tap in ("c2", "c3", "c4", "c5"):
        got = _rows(outs, "eval", tap).transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, ref_eval[tap], atol=2e-5, err_msg=tap)


def test_spatial_hrnet_train_mode_equals_the_reference(hrnet):
    """Train mode: the stem's BatchNorm statistics over all four blocks
    (data and model), the rest over the data axis.  The taps and the
    running statistics to the bounds of ``tests/test_torch_hrnet.py``'s
    train mode (f32 on both sides, batch statistics in another order: max
    |d| / max |ref| < 1e-4)."""
    _, ref_train, stats, outs = hrnet
    for tap in ("c2", "c3", "c4", "c5"):
        got = _rows(outs, "train", tap).transpose(0, 2, 3, 1)
        want = ref_train[tap]
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4, tap
    for o in outs:
        for k, v in stats.items():
            np.testing.assert_allclose(o["stats"][k].numpy(), v, rtol=1e-3,
                                       atol=1e-3 * np.abs(v).max(), err_msg=k)
        assert all(torch.equal(o["stats"][k], outs[0]["stats"][k]) for k in stats)


# ---------------------------------------------------------------------------
# one step in float64 against one process
# ---------------------------------------------------------------------------


def _raw(**over) -> dict:
    """A config-5-shaped FixMatch + CutMix run at width 8 (the HRNet case
    of ``tests/test_torch_ddp_step.py``) on a model axis of 2."""
    raw = {
        "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP,
                 "scale_min": 0.5, "scale_max": 2.0, "hflip_prob": 0.5, "num_workers": 1,
                 "cutmix_impl": "pallas"},
        "model": {"backbone": "hrnet_w48", "decoder": "hrnet_head", "compute_dtype": "float32",
                  "hrnet_width": 8, "hrnet_modules": [1, 1, 1], "branch_conv": "pallas",
                  "remat": "stages:3"},
        "method": {"name": "fixmatch_cutmix", "sup_loss": "ohem", "ohem_min_kept": 2000,
                   "ohem_thresh": 0.1, "conf_thresh": 0.3},
        "optim": {"lr": 0.01, "weight_decay": 1e-4},
        "train": {"labeled_batch_size": 4, "unlabeled_batch_size": 4, "seed": 3},
        "parallel": {"model_parallel": 2},
    }
    for dotted, v in over.items():
        sec, key = dotted.split(".")
        raw[sec][key] = v
    return raw


def _batch(n: int, canvas: int, seed: int, labeled: bool) -> dict:
    rng = np.random.RandomState(seed)
    image = (rng.rand(n, canvas, canvas, 3) * 255).astype(np.uint8)
    label = rng.randint(0, NCLS, (n, canvas, canvas)).astype(np.int32)
    label[rng.rand(n, canvas, canvas) < 0.1] = 255
    if not labeled:
        label[:] = 255
    size = rng.randint(canvas * 3 // 4, canvas + 1, (n, 2)).astype(np.int32)
    return {"image": image, "label": label, "size": size}


# the cases of each mesh: the step in float64 throughout (the branch convs
# on cuDNN's path), and config 5's path, whose plain versions of D and E
# compute in f32 by contract
CASES = {"float64": _raw(**{"model.branch_conv": "xla"}), "pallas": _raw()}


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=["D1xM2", "D2xM2"])
def steps(request, tmp_path_factory):
    """(D, M, {case: the ranks' results}): one spawn per mesh."""
    d, m = request.param
    lab, unlab = _batch(4, CROP + 16, 1, True), _batch(4, CROP + 16, 2, False)
    cases = [(raw, lab, unlab, name == "pallas") for name, raw in CASES.items()]
    outs = run_ranks(ddp_steps, d * m, str(tmp_path_factory.mktemp("steps")), cases, m)
    return d, m, {name: [o[i] for o in outs] for i, name in enumerate(CASES)}


# The float64 step's gradient is chaotic: one process against itself with
# its float64 weights scaled by 1 + 1e-14 N(0, 1) moves 3.4e-12 (by 1e-15:
# 6.4e-14), and the stem's one-pass statistics over the ranks (the
# reference's) round differently from ``F.batch_norm``'s at about that
# size, so the gradient (and the momentum, which is step 0's gradient) is
# held to 1e-10; every other vector to 1e-12.  Config 5's path: the rule
# of ``tests/test_torch_ddp_step.py``'s HRNet case, 1e-5 or the control's
# distance (its f32 weights scaled by 1 + 1e-7 N(0, 1)), whichever is
# larger.
GRAD_LIMIT = 1e-10


@pytest.mark.parametrize("name", list(CASES))
def test_spatial_step_equals_one_process_step(steps, name):
    d, m, cases = steps
    ranks = cases[name]
    r0 = ranks[0]
    assert [r["coords"] for r in ranks] == [(i // m, i % m, i) for i in range(d * m)]
    assert all(r["digest"] == r0["digest"] for r in ranks)  # every rank bit-equal
    assert all(r["collectives"] == r0["collectives"] > 0 for r in ranks)
    assert r0["ref_collectives"] == 0
    # the teacher's and the student's forward: 2 halo pulls and one gather
    # each; the backward: stem2's halo (stem1's input takes no gradient)
    assert all(r["spatial"]["halo"] == 5 and r["spatial"]["gather_h"] == 2 for r in ranks)
    for key, rel in r0["rel"].items():
        if name == "pallas":
            limit = max(1e-5, r0["control_rel"][key])
        else:
            limit = GRAD_LIMIT if key in ("grad", "momentum") else LIMIT
        assert rel <= limit, f"D={d} M={m} {name} {key}: relative distance {rel:.3g} > {limit:.3g}"
    # the step's scalars are f32 (``methods/common.py::global_scalars``)
    for k, v in r0["ref_metrics"].items():
        assert all(r["metrics"][k] == r0["metrics"][k] for r in ranks), k
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5 if name == "pallas" else 1e-6,
                                   atol=1e-7, err_msg=k)
    assert np.isfinite(r0["ref_metrics"]["loss"]) and r0["ref_metrics"]["loss"] > 0


# ---------------------------------------------------------------------------
# the trainer on D = 1 x M = 2
# ---------------------------------------------------------------------------


def _fit_raw(work: str) -> dict:
    raw = _raw(**{"model.branch_conv": "xla", "model.remat": "none", "method.sup_loss": "ce"})
    raw["data"].update({"synthetic_size": 4, "synthetic_canvas": CROP + 32})
    raw["train"].update({"labeled_batch_size": 2, "unlabeled_batch_size": 2, "epochs": 1,
                         "iters_per_epoch": 2, "log_interval": 1, "eval_batch_size": 2,
                         "work_dir": work, "async_checkpoint": False})
    return raw


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("fit_spatial"))
    raw = _fit_raw(work)
    return work, raw, run_ranks(fit, 2, os.path.join(work, "ranks"), raw)


def test_spatial_fit_writes_the_run_files_once(fitted):
    work, raw, outs = fitted
    assert [(o["rank"], o["world_rank"]) for o in outs] == [(0, 0), (0, 1)]
    assert all(o["mesh"] == {"data": 1, "model": 2} and o["step"] == 2 for o in outs)
    with open(os.path.join(work, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["train"]["step"] for r in recs if "train" in r] == [0, 1]
    assert [r["val"]["step"] for r in recs if "val" in r] == [0]
    assert os.path.isfile(os.path.join(work, "config.yaml"))
    assert os.path.isfile(os.path.join(work, "train.log"))
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == ["2"]
    assert outs[0]["state"] == outs[1]["state"]  # bit-equal ranks


def test_spatial_eval_equals_one_process_eval_and_the_slot_restores(fitted):
    """The val pass through the H-sharded stem on both model ranks against
    one process's on the slot's weights (the model ranks score the same
    rows); the slot, restored by one process, is the ranks' state."""
    work, raw, outs = fitted
    one = {**raw, "parallel": {"model_parallel": 1}}
    cfg = config.config_from_dict(one)
    from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval

    state, method, _ = port_eval.load_state(cfg, os.path.join(work, "checkpoints"), "cpu")
    loader = evaluator.val_loader(cfg)
    try:
        cm = evaluator.eval_confusion(evaluator.make_evaluator(cfg),
                                      evaluator.inference_model(state, method), loader, "cpu")
    finally:
        loader.close()
    assert cm.sum() == outs[0]["cm"].sum() > 0
    for o in outs:
        np.testing.assert_array_equal(o["cm"], cm)
    got = resume(0, 1, {**one, "train": {**raw["train"], "resume": "auto", "epochs": 2}})
    assert got["step"] == 2 and got["start_epoch"] == 1
    for key in ("params", "buffers", "momentum"):
        assert got["state"][key] == outs[0]["state"][key], key


# ---------------------------------------------------------------------------
# configuration errors
# ---------------------------------------------------------------------------


def test_model_axis_errors():
    with pytest.raises(ValueError, match="only wired for backbone hrnet_w48"):
        config.config_from_dict({"model": {"backbone": "resnet50"},
                                 "parallel": {"model_parallel": 2}})
    ok = config.ParallelConfig(data_parallel=-1, model_parallel=2)
    assert config.data_parallel_size(ok, 4) == 2 and config.data_parallel_size(ok, 2) == 1
    with pytest.raises(ValueError, match="data_parallel x model_parallel"):
        config.data_parallel_size(ok, 3)
    with pytest.raises(ValueError, match="data_parallel=2 but 2 process"):
        config.data_parallel_size(config.ParallelConfig(data_parallel=2, model_parallel=2), 2)
    with pytest.raises(ValueError, match="data_parallel x model_parallel"):
        mesh_lib.make_mesh(-1, 2)  # one process
    # a model axis reaching a model with no H-sharded block
    cfg = config.config_from_dict({"model": {"backbone": "resnet18", "decoder": "unet"},
                                   "data": {"num_classes": NCLS}})
    mesh = mesh_lib.Mesh({"data": 1, "model": 2}, 0, None, 0, object())
    with pytest.raises(ValueError, match="no block to shard"):
        use_mesh(build_model(cfg), mesh)
