"""Port's stem (kernels B and C, plain versions on the CPU) against the JAX
Pallas stem in interpret mode (ops/pallas_stem.py) and the stem segment
against ``PallasStemSegment``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


# ---------------------------------------------------------------------------
# The kernels' operand layout (csrc/stem.cu) in plain torch
# ---------------------------------------------------------------------------


def _one_ulp(got, want):
    """One bf16 rounding of f32 sums taken in another order: one ulp apart."""
    return bool(((got.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs() + 1e-4).all())


def test_windowed_plain_matches_plain_and_pallas():
    """Through pack_stem_weights and the one-element-shifted 24-wide windows,
    at the file's SHAPE: against the specification and against the Pallas
    kernel in interpret mode (forward and its VJP)."""
    xj, wj, xt, wt = _inputs(8)
    yw, sw = stem.stem_fwd_windowed(xt, wt)
    yp, sp = stem.stem_fwd_plain(xt, wt)
    assert _one_ulp(yw, yp)
    _assert_stats_close(sw.numpy(), sp.numpy())
    (yj, sj), vjp = jax.vjp(lambda w_: pallas_stem.stem_conv_bn_s2(xj, w_, True), wj)
    # bf16 accumulation-order spread only (the JAX suite's own bound)
    np.testing.assert_allclose(yw.float().numpy(), np.asarray(yj, np.float32), atol=8e-3)
    _assert_stats_close(sw.numpy(), np.asarray(sj))

    rng = np.random.RandomState(9)
    dy = (rng.randn(*yp.shape) * 1e-2).astype(np.float32)
    ds = (rng.randn(2, 64) * 1e-3).astype(np.float32)
    dyj = jnp.asarray(dy).astype(jnp.bfloat16)
    (gj,) = vjp((dyj, jnp.asarray(ds)))
    # the same y (JAX's) on both sides, so dY folds from the same values
    y_ref = torch.from_numpy(np.asarray(yj, np.float32)).to(torch.bfloat16)
    dyt = torch.from_numpy(dy).to(torch.bfloat16)
    dst = torch.from_numpy(ds)
    dww = stem.stem_dw_windowed(xt, dyt, y_ref, dst, 7)
    dwp = stem.stem_dw_plain(xt, dyt, y_ref, dst, 7)
    # the same bf16 dY and patches: f32 sums over 4096 pixels in another order
    torch.testing.assert_close(dww, dwp, rtol=0, atol=1e-5 * float(dwp.abs().max()))
    gj = np.asarray(gj)
    # f32 order, and the reference may round a few dY to the neighbouring bf16
    np.testing.assert_allclose(dww.permute(2, 3, 1, 0).numpy(), gj, rtol=0,
                               atol=1e-3 * np.abs(gj).max())


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("n,h,w", [(2, 32, 96), (3, 30, 142)])
def test_windowed_plain_matches_plain(k, n, h, w):
    """Every window geometry the kernels use at small k, at an image whose
    width leaves a ragged tile (142) and an odd number of output rows (30)."""
    rng = np.random.RandomState(k + n)
    x = torch.from_numpy(rng.rand(n, h, w, 3).astype(np.float32) * 4 - 2).to(torch.bfloat16)
    wt = torch.from_numpy((rng.randn(64, 3, k, k) * 0.35 / k).astype(np.float32))
    yw, sw = stem.stem_fwd_windowed(x, wt)
    yp, sp = stem.stem_fwd_plain(x, wt)
    assert tuple(yw.shape) == (n, 64, h // 2, w // 2) and _one_ulp(yw, yp)
    _assert_stats_close(sw.numpy(), sp.numpy())
    dy = torch.from_numpy((rng.randn(*yp.shape) * 1e-2).astype(np.float32)).to(torch.bfloat16)
    ds = torch.from_numpy((rng.randn(2, 64) * 1e-3).astype(np.float32))
    dww = stem.stem_dw_windowed(x, dy, yp, ds, k)
    dwp = stem.stem_dw_plain(x, dy, yp, ds, k)
    # the same bf16 dY and patches: f32 sums in another order
    torch.testing.assert_close(dww, dwp, rtol=0, atol=1e-5 * float(dwp.abs().max()))


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11])
def test_packed_weights_hold_the_taps_and_zero_pads(k):
    w = torch.from_numpy(np.random.RandomState(k).randn(k, k, 3, 64).astype(np.float32)) + 3.0
    packed = stem.pack_stem_weights(w)
    kwid, s, _ = stem.window_geometry(k)
    assert packed.dtype == torch.bfloat16 and tuple(packed.shape) == (64, k * kwid)
    cols = packed.float().reshape(64, k, kwid)
    pads = torch.ones(kwid, dtype=torch.bool)
    pads[s:s + 3 * k] = False
    assert bool((cols[:, :, pads] == 0).all())  # exactly 0 (w is never 0 here)
    want = w.to(torch.bfloat16).float().reshape(k, 3 * k, 64).permute(2, 0, 1)
    assert torch.equal(cols[:, :, s:s + 3 * k], want)


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11])
def test_window_indexing_is_aligned_and_consistent(k):
    """Every window starts at an even element (the kernels' 32-bit operand
    loads), its position s + 3*kw + c is tap (kw, c) of the pixel (staged
    column 2j - p + kw + LEFT, channel c), and the window stays inside the
    staged row of a 128-pixel tile (6 * 128 + 48 bf16)."""
    kwid, s, _ = stem.window_geometry(k)
    p = (k - 1) // 2
    assert kwid % 8 == 0 and kwid >= 3 * k + s
    for j in range(stem.TW):
        start = stem.window_start(j, k)
        assert start % 2 == 0 and start >= 0 and start + kwid <= 6 * stem.TW + 48
        for kw in range(k):
            for c in range(3):
                assert start + s + 3 * kw + c == 3 * (2 * j - p + kw + stem.LEFT) + c


def test_copy_path_choice():
    """The 16-byte copies need W % 16 == 0 and every pointer 16-byte aligned."""
    assert stem.stem_vec((8, 512, 512, 3), (0, 4096, 1 << 20))
    assert not stem.stem_vec((3, 30, 142, 3), (0, 16))
    assert not stem.stem_vec((2, 64, 72, 3), (0,))  # W % 16 == 8
    assert not stem.stem_vec((2, 64, 96, 3), (0, 2))
