"""Port's stem (kernels B and C, plain versions on the CPU) against the JAX
Pallas stem in interpret mode (ops/pallas_stem.py) and the stem segment
against ``PallasStemSegment``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semi_supervised_semantic_segmentation_tpu.models.layers import PallasStemSegment
from semi_supervised_semantic_segmentation_tpu.ops import pallas_stem
from semi_supervised_semantic_segmentation_tpu_torch.engine.compat import load_flax_variables
from semi_supervised_semantic_segmentation_tpu_torch.models.layers import StemSegment
from semi_supervised_semantic_segmentation_tpu_torch.ops import stem

SHAPE = (2, 64, 256, 3)  # the smallest shape the TPU kernel accepts at k=7


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(*SHAPE).astype(np.float32)
    w = ((rng.rand(7, 7, 3, 64) - 0.5) * 0.2).astype(np.float32)  # HWIO
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # OIHW
    return xj, jnp.asarray(w), xt, wt


def _assert_stats_close(got, want):
    # rtol 1e-3 of each row's largest magnitude: the sums run over 32K
    # values in another order, and a handful of y values may round to the
    # neighbouring bf16.
    for row in range(2):
        np.testing.assert_allclose(got[row], want[row], rtol=0,
                                   atol=1e-3 * np.abs(want[row]).max())


def test_stem_fwd_plain_matches_pallas():
    xj, wj, xt, wt = _inputs(0)
    yj, sj = pallas_stem.stem_conv_bn_s2(xj, wj, True)
    yt, st = stem.stem_fwd(xt, wt)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == (2, 64, 32, 128)
    # bf16 accumulation-order spread only (the JAX suite's own bound)
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32), atol=8e-3)
    _assert_stats_close(st.numpy(), np.asarray(sj))


def test_stem_dw_plain_matches_jax_grad_through_both_outputs():
    xj, wj, xt, wt = _inputs(1)
    c = np.random.RandomState(2).randn(2, 64).astype(np.float32) * 1e-3

    def loss_j(w_):
        y, s = pallas_stem.stem_conv_bn_s2(xj, w_, True)
        return jnp.sum(y.astype(jnp.float32) ** 2) + jnp.sum(s * c)

    gj = np.asarray(jax.grad(loss_j)(wj))
    wt = wt.clone().requires_grad_(True)
    y, s = stem.stem_conv_bn(xt, wt)
    ((y.float() ** 2).sum() + (s * torch.from_numpy(c)).sum()).backward()
    gt = wt.grad.permute(2, 3, 1, 0).numpy()
    assert wt.grad.dtype == torch.float32
    # bf16 rounding of dY at different places of the sum + f32 order
    np.testing.assert_allclose(gt, gj, rtol=0, atol=5e-3 * np.abs(gj).max())


def test_stem_stats_cotangent_reaches_dw():
    """A loss on the stats alone gives a nonzero dW equal to the fold."""
    _, _, xt, wt = _inputs(3)
    wt = wt.clone().requires_grad_(True)
    _, s = stem.stem_conv_bn(xt, wt)
    s[0].sum().backward()  # ds0 = 1, ds1 = 0 -> dW = sum of patches
    with torch.no_grad():
        y, _ = stem.stem_fwd(xt, wt)
        want = stem.stem_dw_plain(xt, torch.zeros_like(y), y,
                                  torch.tensor([[1.0] * 64, [0.0] * 64]), 7)
    assert float(wt.grad.abs().max()) > 0
    torch.testing.assert_close(wt.grad, want)


def test_stem_x_gets_no_gradient():
    _, _, xt, wt = _inputs(4)
    x = xt.clone().requires_grad_(True)
    y, s = stem.stem_conv_bn(x, wt.clone().requires_grad_(True))
    (y.float().sum() + s.sum()).backward()
    assert x.grad is None or float(x.grad.abs().max()) == 0.0


def _segment_pair(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(*SHAPE).astype(np.float32)
    seg = PallasStemSegment(64, (7, 7))
    variables = seg.init({"params": jax.random.key(seed)}, jnp.asarray(x), False)
    port = StemSegment(64, 7, impl="pallas")
    load_flax_variables(port, variables["params"], variables["batch_stats"])
    return x, seg, variables, port


def test_stem_segment_matches_pallas_segment_train_and_eval():
    x, seg, v, port = _segment_pair(5)
    (pj, c1j), new = seg.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    port.train()
    pt, c1t = port(torch.from_numpy(x))
    # bf16 activations: the JAX suite's 2e-2, plus one bf16 ulp where a
    # conv output rounded to the neighbouring value scales up through BN
    np.testing.assert_allclose(pt.permute(0, 2, 3, 1).float().detach().numpy(),
                               np.asarray(pj, np.float32), rtol=2.0 ** -7, atol=2e-2)
    np.testing.assert_allclose(c1t.permute(0, 2, 3, 1).float().detach().numpy(),
                               np.asarray(c1j, np.float32), rtol=2.0 ** -7, atol=2e-2)
    bn = new["batch_stats"]["Norm_0"]["BatchNorm_0"]
    np.testing.assert_allclose(port.Norm_0.BatchNorm_0.running_mean.numpy(),
                               np.asarray(bn["mean"]), atol=1e-3)
    np.testing.assert_allclose(port.Norm_0.BatchNorm_0.running_var.numpy(),
                               np.asarray(bn["var"]), atol=1e-3)

    load_flax_variables(port, v["params"], v["batch_stats"])  # undo the train update
    port.eval()
    (pj, _), _ = seg.apply(v, jnp.asarray(x), False, mutable=["batch_stats"])
    with torch.no_grad():
        pt, _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(pt.permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(pj, np.float32), rtol=2.0 ** -7, atol=2e-2)


def test_stem_segment_plain_impl_equals_kernel_impl():
    """impl='conv' (plain conv + BN) and impl='pallas' (stats-folded BN) are
    the same function of the same parameters."""
    x, _, _, port = _segment_pair(6)
    plain = StemSegment(64, 7, impl="conv")
    plain.load_state_dict(port.state_dict())
    xt = torch.from_numpy(x)
    a, _ = port(xt)
    b, _ = plain(xt)
    # F.batch_norm and the folded apply round differently: one bf16 ulp
    np.testing.assert_allclose(a.float().detach().numpy(), b.float().detach().numpy(),
                               rtol=2.0 ** -7, atol=2e-2)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(port.Norm_0.BatchNorm_0, name).numpy(),
                                   getattr(plain.Norm_0.BatchNorm_0, name).numpy(), atol=1e-3)


def test_cuda_wrappers_refuse_cpu_tensors():
    _, _, xt, wt = _inputs(7)
    try:
        stem.stem_fwd_cuda(xt, wt.permute(2, 3, 1, 0).contiguous())
    except ValueError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("stem_fwd_cuda accepted a CPU tensor")
