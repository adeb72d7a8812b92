"""Config 5's step as a whole, reduced: FixMatch + CutMix with OHEM on
HRNet (width 8, ``stage_modules=(1, 1, 1)``) + HRNetV2Head ('up_first') at
crop 128, 2 + 2 images, float32, against the JAX step from the same weights
and batches, for 2 steps.

The port runs config 5's switches: ``branch_conv=pallas`` (the plain
versions of kernels D and E on the CPU; branch 0 is 32x32, so eligible),
remat 'stages:3' and the port's CutMix kernel switch.  The reference runs
its XLA branch path (tests/test_pallas_conv.py holds it equal to the Pallas
path; the Pallas kernels in interpret mode make one step take minutes) and
its XLA CutMix with the box replayed into the port, as in
tests/test_torch_fixmatch.py.  Augmentation is identity and the head has no
dropout, so those are the only random draws.  Before each step the port's
student and teacher are re-synced to the reference's (a random-init HRNet
is chaotic in its gradients: tests/test_torch_hrnet.py).  OHEM keeps the
pixels below the 4000th smallest true-class probability (thresh 0.1), so
the exact k-th order statistic decides the supervised loss."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.engine import compat as jcompat
from semi_supervised_semantic_segmentation_tpu.methods import fixmatch as jfixmatch
from semi_supervised_semantic_segmentation_tpu.models import hrnet as jhrnet
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.methods import fixmatch
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.torch_port_helpers import identity_draws, replay_cutmix_boxes

CROP, NCLS, NL, NU, STEPS = 128, 5, 2, 2, 2
RAW = {
    "data": {"dataset": "synthetic", "num_classes": NCLS, "crop_size": CROP, "scale_min": 1.0,
             "scale_max": 1.0, "hflip_prob": 0.0, "jitter_prob": 0.0, "grayscale_prob": 0.0,
             "blur_prob": 0.0},
    "model": {"backbone": "hrnet_w48", "decoder": "hrnet_head", "compute_dtype": "float32",
              "hrnet_width": 8, "hrnet_modules": [1, 1, 1], "head_fuse": "up_first"},
    "method": {"name": "fixmatch_cutmix", "conf_thresh": 0.3, "ema_alpha": 0.99,
               "rampup_iters": 10, "cutmix_prob": 1.0, "sup_loss": "ohem",
               "ohem_thresh": 0.1, "ohem_min_kept": 4000},
    "optim": {"lr": 0.05, "weight_decay": 5e-4},
    "train": {"labeled_batch_size": NL, "unlabeled_batch_size": NU},
}


class JSeg(fnn.Module):
    """The reference's SegModel tree for the reduced HRNet + head."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False):
        taps = jhrnet.HRNet(width=8, stage_modules=(1, 1, 1), dtype=self.dtype,
                            name="encoder")(x, train)
        return jhrnet.HRNetV2Head(num_classes=NCLS, dtype=self.dtype, fuse_order="up_first",
                                  name="decoder")(taps, x.shape[1:3], train)


def _batches(batch, seed, labeled):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        image = (rng.rand(batch, CROP, CROP, 3) * 255).astype(np.uint8)
        if labeled:
            label = rng.randint(0, NCLS, (batch, CROP, CROP)).astype(np.int32)
            label[rng.rand(batch, CROP, CROP) < 0.1] = 255
        else:
            label = np.full((batch, CROP, CROP), 255, np.int32)
        out.append({"image": image, "label": label,
                    "size": np.full((batch, 2), CROP, np.int32)})
    return out


def _flat(params, stats):
    return jcompat.flatten_params_to_torch_layout(jax.device_get(params), jax.device_get(stats))


def _global_rel(got, want):
    num = sum(np.sum((got[k] - v) ** 2) for k, v in want.items())
    return np.sqrt(num / sum(np.sum(v ** 2) for v in want.values()))


def test_config5_step_with_ohem_matches_jax():
    jcfg = jconfig.config_from_dict(RAW)
    jmodel = JSeg()
    jstate = jfixmatch.init_state(jcfg, jmodel, jax.random.key(0), STEPS)
    jstep = jax.jit(jfixmatch.make_train_step(jcfg, jmodel, STEPS))
    rng0 = np.asarray(jax.device_get(jstate.rng))

    cfg = config.config_from_dict({**RAW, "data": {**RAW["data"], "cutmix_impl": "pallas"},
                                   "model": {**RAW["model"], "branch_conv": "pallas",
                                             "remat": "stages:3"}})
    state = fixmatch.init_state(cfg, build_model(cfg), STEPS)
    step = fixmatch.make_train_step(cfg, STEPS)

    lab, unlab = _batches(NL, 1, True), _batches(NU, 2, False)
    cols = ("loss", "sup_loss", "unsup_loss")
    jl, tl = [], []
    for i in range(STEPS):
        compat.load_flax_variables(state.model, jax.device_get(jstate.params),
                                   jax.device_get(jstate.batch_stats))
        compat.load_flax_variables(state.ema_model, jax.device_get(jstate.ema_params),
                                   jax.device_get(jstate.ema_batch_stats))
        before = _flat(jstate.params, {})
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in lab[i].items()},
                           {k: jnp.asarray(v) for k, v in unlab[i].items()})
        jl.append([float(jm[c]) for c in cols])
        draws = identity_draws(NL, NU, replay_cutmix_boxes(rng0, i, NU, CROP), None)
        tm = step(state, {k: torch.from_numpy(v) for k, v in lab[i].items()},
                  {k: torch.from_numpy(v) for k, v in unlab[i].items()}, draws)
        tl.append([float(tm[c]) for c in cols])
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)

        after = _flat(jstate.params, jstate.batch_stats)
        sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
        for k, v in after.items():
            if "running_" in k:
                # tests/test_torch_model.py's bound: f32 conv order, one-pass variance
                np.testing.assert_allclose(sd[k], v, rtol=1e-3, atol=1e-3 * np.abs(v).max(),
                                           err_msg=k)
        # The update (SGD with momentum, the 10x head group, weight decay) as
        # one vector, within 5% of the reference's: the model's gradients
        # are chaotic (tests/test_torch_hrnet.py prints how far a 1e-7
        # weight move carries them); a wrong LR group, momentum order or
        # loss term moves the update by O(1).
        want = {k: v - before[k] for k, v in after.items() if "running_" not in k}
        got = {k: sd[k] - before[k] for k in want}
        assert _global_rel(got, want) < 5e-2, i
        # the teacher moves by (1 - alpha) of the student: per tensor
        tsd = state.ema_model.state_dict()
        for k, v in _flat(jstate.ema_params, jstate.ema_batch_stats).items():
            rel = np.max(np.abs(v - tsd[k].numpy())) / max(np.max(np.abs(v)), 0.1)
            assert rel < 5e-3, (k, rel)
    jl, tl = np.array(jl), np.array(tl)
    assert np.all(jl[:, 2] > 0)  # the confidence mask let pixels through
    # the losses come from the forward of synced weights: the reference
    # suite's per-step tolerance
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=2e-3)
    assert state.step == STEPS
