"""Config 4's method: the port's cross-pseudo-supervision
(``methods/cps.py``) and its loss (``ops/losses.py::cps_loss``) against the
JAX package's, and its two execution forms against each other:

- ``cps_loss`` with and without the valid mask, and with every pixel
  ignored: value within rtol 1e-6 and gradients of both logits within
  1e-6 (float32);
- 3 CPS steps (``cps_impl: separate``) on U-Net/ResNet-18 (crop 32, 4 + 4
  images, float32, identity augmentation, lr 0.01), both nets carried across
  from the reference's initialisation through
  ``flatten_params_to_torch_layout`` and then left to run: the losses of
  every step within 2e-3 (``cps_loss`` 1e-2: its argmax pseudo-labels
  quantize it), and every tensor of both nets after step 3 within 5e-3
  (max|a-b| / max(max|a|, 0.1)) -- the bounds of the reference suite's own
  CPS trajectory test (tests/test_reference_trajectory.py);
- ``stacked`` (``torch.func.vmap`` over the stacked nets) against
  ``separate`` after one step from the same nets and draws, at the bounds
  of tests/test_engine.py's test of the same (losses rtol 1e-5; parameters
  atol 1e-5, rtol 1e-4), on U-Net/ResNet-18 and on DeepLabV3+/ResNet-18
  with both nets' ASPP dropout masks and ``model.stem_impl=pallas`` (the
  stem's vmap rule).  The losses are compared in float32.  The parameters
  are compared with both nets in float64: in float32 the one-step update
  of these tiny random nets moves by up to 20x that bound between two runs
  of the *same* form at 1 and at 4 intra-op threads (BatchNorm over a few
  pixels amplifies summation-order noise), while in float64 that noise is
  far below it and only a difference between the forms shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.methods import cps as jcps
from semi_supervised_semantic_segmentation_tpu.models.registry import build_model as jbuild
from semi_supervised_semantic_segmentation_tpu.ops import losses as jlosses
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat, evaluator
from semi_supervised_semantic_segmentation_tpu_torch.engine.state import SGD
from semi_supervised_semantic_segmentation_tpu_torch.methods import common, cps, get_method
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.ops import losses
from tests.torch_port_helpers import identity_weak, one_torch_thread, uint8_batches

CROP, NCLS, NL, NU, STEPS = 32, 4, 4, 4, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _raw(decoder="unet", impl="separate", stem_impl="conv", lr=0.01):
    return {
        "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP,
                 "scale_min": 1.0, "scale_max": 1.0, "hflip_prob": 0.0, "jitter_prob": 0.0,
                 "grayscale_prob": 0.0, "blur_prob": 0.0},
        "model": {"backbone": "resnet18", "decoder": decoder,
                  "output_stride": 16 if decoder == "deeplabv3plus" else 32,
                  "compute_dtype": "float32", "stem_impl": stem_impl},
        "method": {"name": "cps", "cps_impl": impl, "cps_weight": 1.5},
        "optim": {"lr": lr, "weight_decay": 1e-4},
        "train": {"labeled_batch_size": NL, "unlabeled_batch_size": NU},
    }


@pytest.mark.parametrize("case", ["plain", "masked", "all_ignored"])
def test_cps_loss_matches_jax(case):
    rng = np.random.RandomState(0)
    l1 = (rng.randn(2, 12, 10, 5) * 3).astype(np.float32)
    l2 = (rng.randn(2, 12, 10, 5) * 3).astype(np.float32)
    mask = {"plain": None, "masked": rng.rand(2, 12, 10) < 0.7,
            "all_ignored": np.zeros((2, 12, 10), bool)}[case]
    jmask = None if mask is None else jnp.asarray(mask)
    want, (g1, g2) = jax.value_and_grad(
        lambda a, b: jlosses.cps_loss(a, b, 255, valid_mask=jmask), argnums=(0, 1))(
        jnp.asarray(l1), jnp.asarray(l2))
    t1, t2 = (torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_() for a in (l1, l2))
    got = losses.cps_loss(t1, t2, 255, None if mask is None else torch.from_numpy(mask))
    got.backward()
    if case == "all_ignored":
        assert float(got.detach()) == float(want) == 0.0
    else:
        assert float(want) > 0
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for t, g in ((t1, g1), (t2, g2)):
        np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g), atol=1e-6)


def _both_nets(state):
    """Every tensor of both nets, by "net1." / "net2." name."""
    out = {f"net1.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"net2.{k}": v for k, v in state.model2.state_dict().items()})
    return out


def test_cps_steps_match_jax():
    assert get_method("cps") is cps and cps.uses_unlabeled and not cps.uses_ema
    raw = _raw()
    jcfg = jconfig.config_from_dict(raw)
    jmodel = jbuild(jcfg)
    jstate = jcps.init_state(jcfg, jmodel, jax.random.key(0), STEPS)
    jstep = jax.jit(jcps.make_train_step(jcfg, jmodel, STEPS))
    cfg = config.config_from_dict(raw)
    state = cps.init_state(cfg, build_model(cfg), STEPS)
    for net, name in ((state.model, "net1"), (state.model2, "net2")):
        compat.load_flax_variables(net, jax.device_get(jstate.params[name]),
                                   jax.device_get(jstate.batch_stats[name]))
    step = cps.make_train_step(cfg, STEPS)
    lab = uint8_batches(STEPS, NL, CROP, NCLS, 5, True)
    unlab = uint8_batches(STEPS, NU, CROP, NCLS, 6, False)
    cols = ("loss", "sup_loss", "cps_loss")
    jl, tl = [], []
    for i in range(STEPS):
        jstate, jm = jstep(jstate, *({k: jnp.asarray(v) for k, v in b[i].items()}
                                      for b in (lab, unlab)))
        tm = step(state, *({k: torch.from_numpy(v) for k, v in b[i].items()}
                           for b in (lab, unlab)),
                  cps.Draws(weak_l=identity_weak(NL), weak_u=identity_weak(NU),
                            dropout1=None, dropout2=None))
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
        jl.append([float(jm[c]) for c in cols])
        tl.append([float(tm[c]) for c in cols])
    jl, tl = np.array(jl), np.array(tl)
    assert state.step == STEPS and np.all(jl[:, 2] > 0)
    np.testing.assert_allclose(tl[:, :2], jl[:, :2], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tl[:, 2], jl[:, 2], rtol=1e-2, atol=1e-2)
    got = _both_nets(state)
    for name in ("net1", "net2"):
        flat = compat.flatten_params_to_torch_layout(jax.device_get(jstate.params[name]),
                                                     jax.device_get(jstate.batch_stats[name]))
        for k, v in flat.items():
            rel = np.max(np.abs(v - got[f"{name}.{k}"].numpy())) / max(np.max(np.abs(v)), 0.1)
            assert rel < 5e-3, (name, k, rel)


def _to_float64(state, cfg):
    """Both nets in float64 (parameters, buffers and compute dtype), and a
    fresh SGD over them."""
    for net in state.nets():
        net.double()
        for mod in net.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.float64
    state.optimizer = SGD(cfg, state.nets(), 10)


def _one_step(raw, float64: bool):
    cfg = config.config_from_dict(raw)
    state = cps.init_state(cfg, build_model(cfg), 10)
    if float64:
        _to_float64(state, cfg)
    lab = uint8_batches(1, NL, CROP, NCLS, 0, True)[0]
    unlab = uint8_batches(1, NU, CROP, NCLS, 1, False)[0]
    lab_t, unlab_t = common.to_device(lab, "cpu"), common.to_device(unlab, "cpu")
    draws = cps.draw(cfg, state.model, lab_t, unlab_t, common.step_generator(3, 0, "cpu"))
    metrics = cps.make_train_step(cfg, 10)(state, lab_t, unlab_t, draws)
    return metrics, state, draws


@pytest.mark.parametrize("decoder,stem_impl", [("unet", "conv"), ("deeplabv3plus", "pallas")])
def test_stacked_equals_separate_after_one_step(decoder, stem_impl):
    for float64 in (False, True):
        (ms, ss, ds), (mk, sk, dk) = (_one_step(_raw(decoder, impl, stem_impl), float64)
                                      for impl in ("separate", "stacked"))
        if decoder == "deeplabv3plus":
            assert ds.dropout1.shape == (NL + NU, 256, CROP // 16, CROP // 16)
            assert torch.equal(ds.dropout1, dk.dropout1) and torch.equal(ds.dropout2, dk.dropout2)
            assert not torch.equal(ds.dropout1, ds.dropout2)
        else:
            assert ds.dropout1 is None and ds.dropout2 is None
        if not float64:
            for k in ("loss", "sup_loss", "cps_loss"):
                np.testing.assert_allclose(float(mk[k]), float(ms[k]), rtol=1e-5, err_msg=k)
            continue
        params = {f"net{i}.{n}" for i, net in ((1, ss.model), (2, ss.model2))
                  for n, _ in net.named_parameters()}
        a, b = _both_nets(ss), _both_nets(sk)
        assert set(a) == set(b)
        for k in a:
            # parameters at the reference suite's bounds; BN running statistics too
            torch.testing.assert_close(b[k], a[k], atol=1e-5, rtol=1e-4, msg=k)
        assert params < set(a)
        assert evaluator.inference_model(sk, cps) is sk.model


def test_stacked_raises_where_vmap_cannot_carry_the_dropout():
    """``stacked`` with a DeepLabV3+ and no keep-masks would draw the
    dropout inside ``vmap``: it raises, and runs nothing else instead."""
    cfg = config.config_from_dict(_raw("deeplabv3plus", "stacked"))
    state = cps.init_state(cfg, build_model(cfg), 10)
    lab = common.to_device(uint8_batches(1, NL, CROP, NCLS, 0, True)[0], "cpu")
    unlab = common.to_device(uint8_batches(1, NU, CROP, NCLS, 1, False)[0], "cpu")
    draws = cps.Draws(weak_l=identity_weak(NL), weak_u=identity_weak(NU), dropout1=None,
                      dropout2=None)
    with pytest.raises(RuntimeError, match="random"):
        cps.make_train_step(cfg, 10)(state, lab, unlab, draws)
    assert state.step == 0
    with pytest.raises(ValueError, match="both nets"):
        cps.stacked_forward(state.model, state.model2, torch.zeros(1, CROP, CROP, 3),
                            torch.ones(1, 256, 2, 2, dtype=torch.bool), None)


def test_stacked_runs_in_bfloat16():
    """The card's dtype: ``stacked`` normalizes bf16 under ``vmap`` in f32
    (``layers.vmapped``); its losses stay within 1e-3 (relative) of
    ``separate``'s from the same nets and draws (1e-4 measured)."""
    raw = _raw("deeplabv3plus", stem_impl="pallas")
    raw["model"]["compute_dtype"] = "bfloat16"
    (ms, _, _), (mk, sk, _) = (_one_step({**raw, "method": {**raw["method"], "cps_impl": impl}},
                                         False) for impl in ("separate", "stacked"))
    for k in ("loss", "sup_loss", "cps_loss"):
        assert np.isfinite(float(mk[k]))
        np.testing.assert_allclose(float(mk[k]), float(ms[k]), rtol=1e-3, err_msg=k)
    assert all(torch.isfinite(v).all() for v in _both_nets(sk).values())
