"""The port's HRNet (``models/hrnet.py``) against the JAX package's, in
float32 from the same weights (``load_flax_variables``):

- ``HRModule`` with branches (8, 16), both branches eligible for the fused
  branch conv: the reference runs its Pallas kernels in interpret mode, the
  port its plain versions (``branch_conv='pallas'``) or cuDNN's path
  (``'xla'``); outputs, running statistics and every gradient;
- HRNet (width 8, ``stage_modules=(1, 1, 1)``, as tests/test_models.py
  builds it) + HRNetV2Head at crop 128, where branch 0 (32x32) is eligible:
  train-mode logits, running statistics and the gradient with the head's
  'up_first' order, eval logits with 'conv_first'.  The reference side runs
  its XLA branch path, which tests/test_pallas_conv.py holds equal to its
  Pallas path; the port runs both of its paths;
- the ``state_dict()`` keys are the reference's flattened keys;
- remat 'stages:3' (and 'branches:3') against none in the port: the same
  loss, gradients and running statistics (torch re-runs the checkpointed
  forward, which must not update BatchNorm's running statistics twice).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.models import hrnet as jhrnet
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.models.hrnet import HRModule

NCLS, CROP = 5, 128


class JSeg(fnn.Module):
    """The reference's SegModel tree for HRNet + HRNetV2Head at a reduced
    width: ``encoder`` = HRNet, ``decoder`` = HRNetV2Head."""

    dtype: object = jnp.float32
    branch_conv: str = "xla"
    fuse_order: str = "up_first"

    @fnn.compact
    def __call__(self, x, train: bool = False):
        taps = jhrnet.HRNet(width=8, stage_modules=(1, 1, 1), dtype=self.dtype,
                            branch_conv=self.branch_conv, name="encoder")(x, train)
        return jhrnet.HRNetV2Head(num_classes=NCLS, dtype=self.dtype, fuse_order=self.fuse_order,
                                  name="decoder")(taps, x.shape[1:3], train)


def _cfg(branch_conv="xla", head_fuse="up_first", remat="none"):
    return config.config_from_dict({
        "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP},
        "model": {"backbone": "hrnet_w48", "decoder": "hrnet_head", "compute_dtype": "float32",
                  "hrnet_width": 8, "hrnet_modules": [1, 1, 1], "branch_conv": branch_conv,
                  "head_fuse": head_fuse, "remat": remat},
    })


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6)


def _global_rel(got, want):
    """|got - want| / |want| over all tensors as one vector."""
    num = sum(np.sum((got[k] - v) ** 2) for k, v in want.items())
    return np.sqrt(num / sum(np.sum(v ** 2) for v in want.values()))


def _close_stats(flat, sd):
    """Running statistics: the bound of tests/test_torch_model.py (f32 conv
    order; one-pass reference variance vs torch's)."""
    n = 0
    for k, v in flat.items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-3, atol=1e-3 * np.abs(v).max(),
                                       err_msg=k)
            n += 1
    assert n > 0


def _grads_close(named_grads, jgrads_flat, bound):
    """Per tensor, relative to the tensor's own scale or, for gradients that
    are 0 in exact arithmetic (a bias right before a BatchNorm), to 1e-3 of
    the largest gradient."""
    floor = 1e-3 * max(np.max(np.abs(v)) for v in jgrads_flat.values())
    for k, v in jgrads_flat.items():
        got = named_grads[k].numpy()
        assert got.shape == v.shape, k
        err = np.max(np.abs(got - v)) / max(np.max(np.abs(v)), floor)
        assert err < bound, (k, err)


# --------------------------------------------------------------- HRModule


@pytest.fixture(scope="module")
def module_ref():
    rng = np.random.RandomState(2)
    xs = [rng.randn(2, 64, 16, 8).astype(np.float32), rng.randn(2, 32, 8, 16).astype(np.float32)]
    cots = [rng.randn(*x.shape).astype(np.float32) for x in xs]
    mod = jhrnet.HRModule(channels=(8, 16), num_blocks=2, branch_conv="pallas", dtype=jnp.float32)
    jxs = [jnp.asarray(x) for x in xs]
    v = mod.init(jax.random.PRNGKey(0), jxs, False)
    # non-trivial BN affine parameters, so the folded (mul, add) matter
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jnp.asarray(rng.randn(*a.shape), jnp.float32)
        if jax.tree_util.keystr(p).endswith(("['scale']", "['bias']")) else a, v["params"])

    def loss(p):
        outs, upd = mod.apply({"params": p, "batch_stats": v["batch_stats"]}, jxs, True,
                              mutable=["batch_stats"])
        return sum(jnp.vdot(o, jnp.asarray(c)) for o, c in zip(outs, cots)), (outs, upd)

    grads, (outs, upd) = jax.jit(jax.grad(loss, has_aux=True))(params)
    evals = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, jxs, False)
    return dict(xs=xs, cots=cots, params=jax.device_get(params), stats=jax.device_get(v["batch_stats"]),
                outs=[np.asarray(o) for o in outs], evals=[np.asarray(o) for o in evals],
                new_stats=jax.device_get(upd["batch_stats"]), grads=jax.device_get(grads))


@pytest.mark.parametrize("branch_conv", ["pallas", "xla"])
def test_hrmodule_matches_jax(module_ref, branch_conv):
    r = module_ref
    mod = HRModule((8, 16), num_blocks=2, compute_dtype=torch.float32, branch_conv=branch_conv)
    compat.load_flax_variables(mod, r["params"], r["stats"])
    xs = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))) for x in r["xs"]]
    mod.eval()
    with torch.no_grad():
        for got, want in zip(mod(xs), r["evals"]):
            assert _rel(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4
    mod.train()
    outs = mod(xs)
    sum((o * torch.from_numpy(np.ascontiguousarray(c.transpose(0, 3, 1, 2)))).sum()
        for o, c in zip(outs, r["cots"])).backward()
    for got, want in zip(outs, r["outs"]):
        # f32 on both sides: summation order only
        assert _rel(got.detach().permute(0, 2, 3, 1).numpy(), want) < 1e-4
    _close_stats(jcompat.flatten_params_to_torch_layout(r["params"], r["new_stats"]),
                 mod.state_dict())
    _grads_close({k: p.grad for k, p in mod.named_parameters()},
                 jcompat.flatten_params_to_torch_layout(r["grads"], {}), 1e-3)


# ------------------------------------------------------ HRNet + HRNetV2Head


@pytest.fixture(scope="module")
def seg_ref():
    rng = np.random.RandomState(0)
    x = rng.randn(2, CROP, CROP, 3).astype(np.float32)
    cot = rng.randn(2, CROP, CROP, NCLS).astype(np.float32)
    train_model, eval_model = JSeg(fuse_order="up_first"), JSeg(fuse_order="conv_first")
    v = jax.jit(lambda xx: train_model.init(jax.random.key(0), xx, False))(jnp.asarray(x))
    params, stats = v["params"], v["batch_stats"]

    def loss(p):
        out, upd = train_model.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), True,
                                     mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(cot)), (out, upd)

    grad_fn = jax.jit(jax.grad(loss, has_aux=True))
    grads, (logits, upd) = grad_fn(params)
    # the reference's own gradient from weights moved by 1e-7 (relative):
    # how far its gradient chaos alone carries it
    prng = np.random.RandomState(1)
    moved = jax.tree_util.tree_map(
        lambda a: a * (1.0 + 1e-7 * jnp.asarray(prng.randn(*a.shape), jnp.float32)), params)
    grads_moved = grad_fn(moved)[0]
    evals = jax.jit(lambda p, s: eval_model.apply({"params": p, "batch_stats": s},
                                                  jnp.asarray(x), False))(params, stats)
    return dict(x=x, cot=cot, params=jax.device_get(params), stats=jax.device_get(stats),
                logits=np.asarray(logits), evals=np.asarray(evals),
                new_stats=jax.device_get(upd["batch_stats"]), grads=jax.device_get(grads),
                grads_moved=jax.device_get(grads_moved))


def test_state_dict_keys_are_the_flattened_reference_keys(seg_ref):
    keys = set(build_model(_cfg()).state_dict())
    assert keys == set(jcompat.flatten_params_to_torch_layout(seg_ref["params"], seg_ref["stats"]))
    assert {"encoder.stage3_m0.branch1_block3.conv2.Conv_0.weight",
            "encoder.stage4_m0.fuse_down_0_to_3_2.Norm_0.BatchNorm_0.running_var",
            "decoder.fuse_norm.BatchNorm_0.weight", "decoder.fuse0.bias"} <= keys


@pytest.mark.parametrize("branch_conv", ["pallas", "xla"])
def test_hrnet_with_head_matches_jax(seg_ref, branch_conv):
    r = seg_ref
    x = torch.from_numpy(r["x"])
    model = build_model(_cfg(branch_conv, "conv_first"))
    compat.load_flax_variables(model, r["params"], r["stats"])
    model.eval()
    with torch.no_grad():
        # f32 conv order (the bound of tests/test_torch_model.py)
        assert _rel(model(x).permute(0, 2, 3, 1).numpy(), r["evals"]) < 1e-3
    model = build_model(_cfg(branch_conv, "up_first"))
    compat.load_flax_variables(model, r["params"], r["stats"])
    model.train()
    logits = model(x)
    (logits * torch.from_numpy(r["cot"]).permute(0, 3, 1, 2)).sum().backward()
    assert _rel(logits.detach().permute(0, 2, 3, 1).numpy(), r["logits"]) < 1e-3
    _close_stats(jcompat.flatten_params_to_torch_layout(r["params"], r["new_stats"]),
                 model.state_dict())
    # The whole gradient as one vector: a random-init HRNet at this size is
    # numerically chaotic in its gradients (branch 3 normalizes over 32
    # values per channel), so single tensors are no measure.  The
    # reference's own gradient from weights moved by 1e-7 shows how far
    # that chaos alone goes (printed beside the port's distance); a wrong
    # layer, order or BatchNorm moves the gradient by O(1).
    want = jcompat.flatten_params_to_torch_layout(r["grads"], {})
    moved = jcompat.flatten_params_to_torch_layout(r["grads_moved"], {})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    rel, chaos = _global_rel(got, want), _global_rel(moved, want)
    floor = 1e-3 * max(np.max(np.abs(v)) for v in want.values())  # as in _grads_close
    worst = max(np.max(np.abs(moved[k] - v)) / max(np.max(np.abs(v)), floor)
                for k, v in want.items())
    print(f"gradient as one vector: port {rel:.4f} from the reference; the reference "
          f"under a 1e-7 weight move {chaos:.4f} (worst single tensor {worst:.4f})")
    assert rel < 5e-2, (rel, chaos)


@pytest.mark.parametrize("plan", ["stages:3", "branches:3"])
def test_remat_changes_nothing_but_memory(seg_ref, plan):
    """Bit-equal loss, gradients and running statistics with and without
    the remat plan (the double-update trap: a re-run forward that updated
    the running statistics would move them twice)."""
    x = torch.from_numpy(seg_ref["x"])
    runs = []
    for remat in (plan, "none"):
        model = build_model(_cfg("pallas", "up_first", remat))
        compat.load_flax_variables(model, seg_ref["params"], seg_ref["stats"])
        model.train()
        loss = (model(x).float() ** 2).mean()
        loss.backward()
        runs.append((loss.detach(), {k: p.grad for k, p in model.named_parameters()},
                     model.state_dict()))
    (l1, g1, s1), (l0, g0, s0) = runs
    assert torch.equal(l1, l0)
    assert all(torch.equal(g1[k], g0[k]) for k in g0)
    assert all(torch.equal(s1[k], s0[k]) for k in s0)
    assert any(not torch.equal(s0[k], torch.from_numpy(np.asarray(v)))
               for k, v in compat.flatten_params_to_torch_layout(seg_ref["params"],
                                                                 seg_ref["stats"]).items()
               if "running_" in k)
