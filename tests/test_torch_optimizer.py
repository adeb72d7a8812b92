"""``optim.grad_clip_norm`` and ``optim.nesterov`` of the port's SGD
(``…_torch/engine/state.py``) against the reference's optax chain
(``engine/state.py::make_optimizer``): 6 steps of the same seeded
gradients through both groups (backbone, and the 10x ``decoder`` head),
float32 on both sides.  After every step each parameter's update so far
(its value less its initial one) is held to the reference's within
``UPDATE_RTOL`` of its largest element.

The weights are near 1e-4 and the gradients' global norm near 5e-4, so
float32 rounds the updates at about 1e-6 of themselves, a clip at 2.5e-4
scales every step and a clip at 1.0 none (each case asserts which).  At
that norm the rule ``max_norm / (|g| + 1e-6)`` of
``torch.nn.utils.clip_grad_norm_`` moves the update by 2e-3 of itself:
only ``optax.clip_by_global_norm``'s ``max_norm / |g|`` passes.  In CPS one
norm covers both nets (the reference's optax chain over ``{'net1',
'net2'}``): net2's gradients are 3x net1's here, so a norm per net would
scale net1 by another factor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import state as jstate
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import state as tstate

STEPS = 6
UPDATE_RTOL = 2e-5
CLIP = 2.5e-4
SHAPES = {"encoder": {"w": (4, 3), "b": (4,)}, "decoder": {"w": (5, 2)}}
CASES = {
    "clip_above": {"grad_clip_norm": CLIP},
    "clip_below": {"grad_clip_norm": 1.0},
    "nesterov": {"nesterov": True},
    "nesterov_clip_above": {"nesterov": True, "grad_clip_norm": CLIP},
}


class _Net(torch.nn.Module):
    """Parameters named as the reference tree's leaves (``encoder.w``, ...)."""

    def __init__(self, tree):
        super().__init__()
        for group, leaves in tree.items():
            mod = torch.nn.Module()
            for name, v in leaves.items():
                mod.register_parameter(name, torch.nn.Parameter(torch.from_numpy(v.copy())))
            setattr(self, group, mod)


def _tree(rng, scale):
    return {g: {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in leaves.items()}
            for g, leaves in SHAPES.items()}


def _run(optim: dict, nets: int):
    """6 steps of both sides on ``nets`` nets (CPS: 2) from the same
    weights and gradients; returns the largest relative error of any
    parameter's update after any step, and each step's global gradient
    norm."""
    raw = {"data": {"dataset": "synthetic"},
           "optim": {"lr": 0.5, "weight_decay": 1e-3, **optim}}
    rng = np.random.RandomState(0)
    names = ["net1", "net2"][:nets]
    trees = {n: _tree(rng, 1e-4) for n in names}
    tx = jstate.make_optimizer(jconfig.config_from_dict(raw), STEPS)
    jparams = jax.tree.map(jnp.asarray, trees if nets > 1 else trees["net1"])
    opt = tx.init(jparams)
    models = [_Net(trees[n]) for n in names]
    sgd = tstate.SGD(config.config_from_dict(raw), models, STEPS)
    worst, norms = 0.0, []
    for i in range(STEPS):
        grads = {n: _tree(rng, 1e-4 * (1 + 2 * k)) for k, n in enumerate(names)}
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                       for t in grads.values() for g in t.values()
                                       for v in g.values()))))
        jgrads = jax.tree.map(jnp.asarray, grads if nets > 1 else grads["net1"])
        upd, opt = tx.update(jgrads, opt, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        for n, model in zip(names, models):
            for name, p in model.named_parameters():
                group, leaf = name.split(".")
                p.grad = torch.from_numpy(grads[n][group][leaf])
        sgd.step(i)
        for n, model in zip(names, models):
            want_tree = jparams[n] if nets > 1 else jparams
            for name, p in model.named_parameters():
                group, leaf = name.split(".")
                init = trees[n][group][leaf]
                want = np.asarray(want_tree[group][leaf]) - init
                got = p.detach().numpy() - init
                rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
                assert rel <= UPDATE_RTOL, (i, n, name, rel)
                worst = max(worst, rel)
    return worst, norms


@pytest.mark.parametrize("case", sorted(CASES))
def test_sgd_knobs_match_make_optimizer(case):
    optim = CASES[case]
    worst, norms = _run(optim, nets=1)
    print(f"{case}: largest relative update error {worst:.3g}")
    clip = optim.get("grad_clip_norm", 0.0)
    if clip:
        # the case is what its name says: every step clipped, or none
        assert all((n >= clip) == case.endswith("above") for n in norms), norms


@pytest.mark.parametrize("nesterov", [False, True])
def test_cps_clips_both_nets_by_one_global_norm(nesterov):
    worst, norms = _run({"grad_clip_norm": CLIP, "nesterov": nesterov}, nets=2)
    print(f"cps, nesterov {nesterov}: largest relative update error {worst:.3g}")
    assert min(norms) > CLIP


def test_clip_by_global_norm_is_optax_rule():
    """The helper alone, on gradients of two dtypes' worth of tensors: the
    optax result to f32 rounding, above and below the norm, and exactly
    unchanged below it."""
    rng = np.random.RandomState(3)
    grads = [rng.randn(7, 3).astype(np.float32), rng.randn(11).astype(np.float32)]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    from optax import clip_by_global_norm

    for max_norm in (0.5 * norm, 2.0 * norm):
        want, _ = clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        tstate.clip_by_global_norm(got, max_norm)
        for a, b, g in zip(got, want, grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
            if max_norm > norm:
                assert np.array_equal(a.numpy(), g)
