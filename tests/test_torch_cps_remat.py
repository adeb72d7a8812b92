"""CPS's ``stacked`` form under a remat plan (``…_torch/methods/cps.py``).

``torch.utils.checkpoint`` cannot run inside ``torch.func.vmap``: its
backward's re-run meets tensors from inside the vmapped function.  So under
``layers.vmapped()`` no plan checkpoints (``layers.remat_active``), and
``stacked`` keeps every activation whatever the plan; ``separate`` still
checkpoints.  Remat changes no value, so:

- ``stacked`` with ``stages:3`` on a width-8 HRNet (modules 1, 1, 1) and
  with ``blocks`` on U-Net/ResNet-18 equal ``separate`` with the same plan
  after one step from the same nets and draws, at tests/test_torch_cps.py's
  bounds: the losses in float32 within rtol 1e-5, and every tensor of both
  nets (parameters and BatchNorm running statistics) in float64 within
  atol 1e-5, rtol 1e-4.  The running statistics are updated once: both
  forms' equal those of ``separate`` with no plan at the same bounds, and
  the ``stacked`` forward runs each checkpointed module once.
- ``stacked`` with ``blocks`` on U-Net/ResNet-18 against the reference's
  ``stacked`` with ``blocks`` (``jax.vmap`` over ``nn.remat``), both nets
  carried over from the reference's initialisation, one step: the losses
  within 2e-3 (``cps_loss`` 1e-2) and every tensor within 5e-3
  (max|a-b| / max(max|a|, 0.1)), tests/test_torch_cps.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.methods import cps as jcps
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.methods import common, cps
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.test_torch_cps import _both_nets, _to_float64
from tests.torch_port_helpers import identity_weak, one_torch_thread, uint8_batches

NCLS, NL, NU = 4, 2, 2
MODELS = {
    "hrnet_w8": ({"backbone": "hrnet_w48", "decoder": "hrnet_head", "hrnet_width": 8,
                  "hrnet_modules": [1, 1, 1]}, "stages:3", 64),
    "unet_r18": ({"backbone": "resnet18", "decoder": "unet", "output_stride": 32},
                 "blocks", 32),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _raw(model: str, impl: str, remat: str):
    m, _, crop = MODELS[model]
    return {"data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": crop,
                     "scale_min": 1.0, "scale_max": 1.0, "hflip_prob": 0.0, "jitter_prob": 0.0,
                     "grayscale_prob": 0.0, "blur_prob": 0.0},
            "model": {**m, "compute_dtype": "float32", "remat": remat},
            "method": {"name": "cps", "cps_impl": impl, "cps_weight": 1.5},
            "optim": {"lr": 0.01, "weight_decay": 1e-4},
            "train": {"labeled_batch_size": NL, "unlabeled_batch_size": NU}}


def _checkpointed(model: torch.nn.Module):
    """The modules a plan checkpoints: HRNet's stage-3 modules, or every
    residual block of a ResNet."""
    enc = model.encoder
    if hasattr(enc, "stage_modules"):
        return [getattr(enc, f"stage3_m{m}") for m in range(enc.stage_modules[1])]
    return [getattr(enc, f"layer{s + 1}_{b}") for s in range(4) for b in range(enc.layers[s])]


def _one_step(model: str, impl: str, remat: str, float64: bool):
    raw = _raw(model, impl, remat)
    cfg = config.config_from_dict(raw)
    state = cps.init_state(cfg, build_model(cfg), 10)
    if float64:
        _to_float64(state, cfg)
    calls = []
    for mod in _checkpointed(state.model):
        mod.register_forward_pre_hook(lambda m, args: calls.append(1))
    crop = raw["data"]["crop_size"]
    lab = common.to_device(uint8_batches(1, NL, crop, NCLS, 0, True)[0], "cpu")
    unlab = common.to_device(uint8_batches(1, NU, crop, NCLS, 1, False)[0], "cpu")
    draws = cps.draw(cfg, state.model, lab, unlab, common.step_generator(3, 0, "cpu"))
    metrics = cps.make_train_step(cfg, 10)(state, lab, unlab, draws)
    return metrics, state, len(calls) // len(_checkpointed(state.model))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_stacked_under_remat_equals_separate(model):
    plan = MODELS[model][1]
    for float64 in (False, True):
        (ms, ss, rs), (mk, sk, rk) = (_one_step(model, impl, plan, float64)
                                      for impl in ("separate", "stacked"))
        # separate's net1 re-runs each checkpointed module; stacked runs it once
        assert (rs, rk) == (2, 1)
        if not float64:
            for k in ("loss", "sup_loss", "cps_loss"):
                np.testing.assert_allclose(float(mk[k]), float(ms[k]), rtol=1e-5, err_msg=k)
            continue
        _, sn, rn = _one_step(model, "separate", "none", True)
        assert rn == 1
        a, b, none = _both_nets(ss), _both_nets(sk), _both_nets(sn)
        assert set(a) == set(b) == set(none)
        assert any("running_mean" in k for k in a)
        for k in a:
            torch.testing.assert_close(b[k], a[k], atol=1e-5, rtol=1e-4, msg=k)
            torch.testing.assert_close(b[k], none[k], atol=1e-5, rtol=1e-4, msg=k)


def test_stacked_blocks_matches_the_reference_stacked_blocks():
    raw = _raw("unet_r18", "stacked", "blocks")
    crop = raw["data"]["crop_size"]
    jcfg = jconfig.config_from_dict(raw)
    jmodel = jbuild(jcfg)
    assert jmodel.remat == "blocks"
    jstate = jcps.init_state(jcfg, jmodel, jax.random.key(0), 1)
    cfg = config.config_from_dict(raw)
    state = cps.init_state(cfg, build_model(cfg), 1)
    for net, name in ((state.model, "net1"), (state.model2, "net2")):
        compat.load_flax_variables(net, jax.device_get(jstate.params[name]),
                                   jax.device_get(jstate.batch_stats[name]))
    lab = uint8_batches(1, NL, crop, NCLS, 5, True)[0]
    unlab = uint8_batches(1, NU, crop, NCLS, 6, False)[0]
    jstate, jm = jax.jit(jcps.make_train_step(jcfg, jmodel, 1))(
        jstate, *({k: jnp.asarray(v) for k, v in b.items()} for b in (lab, unlab)))
    tm = cps.make_train_step(cfg, 1)(
        state, *({k: torch.from_numpy(v) for k, v in b.items()} for b in (lab, unlab)),
        cps.Draws(weak_l=identity_weak(NL), weak_u=identity_weak(NU), dropout1=None,
                  dropout2=None))
    for k, tol in (("loss", 2e-3), ("sup_loss", 2e-3), ("cps_loss", 1e-2)):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol, atol=tol, err_msg=k)
    got = _both_nets(state)
    for name in ("net1", "net2"):
        flat = compat.flatten_params_to_torch_layout(jax.device_get(jstate.params[name]),
                                                     jax.device_get(jstate.batch_stats[name]))
        for k, v in flat.items():
            rel = np.max(np.abs(v - got[f"{name}.{k}"].numpy())) / max(np.max(np.abs(v)), 0.1)
            assert rel < 5e-3, (name, k, rel)
