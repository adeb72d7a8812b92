"""Port's ops (resize, losses, schedules, augmentation cores) against the JAX
package's functions on the same inputs and the same sampled parameters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu.ops import augment as jaug
from semi_supervised_semantic_segmentation_tpu.ops import losses as jlosses
from semi_supervised_semantic_segmentation_tpu.ops import resize as jresize
from semi_supervised_semantic_segmentation_tpu.ops import schedules as jsched
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, losses, resize, schedules

F32_TOL = 1e-5  # float32 elementwise chains evaluated in another order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.transpose(a, (0, 3, 1, 2)))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((8, 12), (32, 48)), ((33, 17), (16, 9)), ((4, 4), (4, 4))])
def test_resize_bilinear_matches(align_corners, in_hw, out_hw):
    x = np.random.RandomState(0).randn(2, *in_hw, 5).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw, align_corners))
    got = resize.resize_bilinear(_nchw(x), out_hw, align_corners).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL)


def _logits_labels(seed, ignore_frac=0.2, c=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(3, 9, 11, c).astype(np.float32) * 2
    labels = rng.randint(0, c, (3, 9, 11)).astype(np.int32)
    labels[rng.rand(3, 9, 11) < ignore_frac] = 255
    return logits, labels


@pytest.mark.parametrize("ignore_frac", [0.2, 1.0])
def test_cross_entropy_matches(ignore_frac):
    logits, labels = _logits_labels(1, ignore_frac)
    want = float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 255))
    got = float(losses.cross_entropy(_nchw(logits), _t(labels), 255))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("normalize", ["all", "masked"])
def test_confidence_masked_ce_matches(normalize):
    logits, labels = _logits_labels(2)
    conf = np.random.RandomState(3).rand(3, 9, 11) > 0.4
    want = float(jlosses.confidence_masked_ce(jnp.asarray(logits), jnp.asarray(labels),
                                              jnp.asarray(conf), 255, normalize))
    got = float(losses.confidence_masked_ce(_nchw(logits), _t(labels), _t(conf), 255, normalize))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_pseudo_labels_match():
    logits, _ = _logits_labels(4)
    jl, jc = jlosses.pseudo_labels_from_logits(jnp.asarray(logits), 0.5)
    tl, tc = losses.pseudo_labels_from_logits(_nchw(logits), 0.5)
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("step", [0, 1, 37, 99, 100, 150])
def test_schedules_match(step):
    np.testing.assert_allclose(schedules.poly_lr(step, 0.01, 100, 0.9),
                               float(jsched.poly_lr(step, 0.01, 100, 0.9)), rtol=1e-6)
    for kind in ("sigmoid", "linear"):
        for ramp in (0, 40):
            np.testing.assert_allclose(
                schedules.consistency_weight(step, 2.0, ramp, kind),
                float(jsched.consistency_weight(step, 2.0, ramp, kind)), rtol=1e-6)


@pytest.mark.parametrize(
    "h,w,s,oy,ox,flip",
    [(40, 56, 1.3, 5, 9, False), (40, 56, 0.5, 0, 0, True), (33, 47, 2.0, 20, 30, True),
     (32, 32, 1.0, 0, 0, False)],
)
def test_scale_crop_flip_matches_jax_core(h, w, s, oy, ox, flip):
    """Batch of two canvases (the second with its own parameters) against
    the reference's per-sample deterministic core."""
    crop, fill = 32, (0.485, 0.456, 0.406)
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 60, 60, 3) * 255).astype(np.uint8)
    lab = rng.randint(0, 5, (2, 60, 60)).astype(np.int32)
    sizes = np.array([[h, w], [60, 44]], np.int32)
    params = [(s, oy, ox, flip), (0.8, 3.0, 1.0, not flip)]
    p = augment.WeakParams(scale=_t(np.float32([q[0] for q in params])),
                           oy=_t(np.float32([q[1] for q in params])),
                           ox=_t(np.float32([q[2] for q in params])),
                           flip=_t(np.array([q[3] for q in params])))
    gi, gl, gv = augment.scale_crop_flip(_t(img), _t(lab), _t(sizes), p, crop_size=crop,
                                         fill_rgb=fill, ignore_index=255)
    for b, (sb, oyb, oxb, fb) in enumerate(params):
        ji, jl, jv = jaug.scale_crop_flip_single(
            jnp.asarray(img[b]), jnp.asarray(lab[b]), jnp.asarray(sizes[b]), jnp.float32(sb),
            jnp.float32(oyb), jnp.float32(oxb), jnp.asarray(fb), crop_size=crop,
            fill_rgb=fill, ignore_index=255)
        np.testing.assert_allclose(gi[b].numpy(), np.asarray(ji), atol=F32_TOL)
        np.testing.assert_array_equal(gl[b].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(gv[b].numpy(), np.asarray(jv))


def _img(seed, b=3):
    return np.random.RandomState(seed).rand(b, 8, 10, 3).astype(np.float32)


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation", "hue"])
def test_color_ops_match_per_sample_factor(op):
    x = _img(5)
    factors = np.float32([0.6, 1.0, 1.4]) if op != "hue" else np.float32([-0.2, 0.05, 0.24])
    got = getattr(augment, f"adjust_{op}")(_t(x), _t(factors)).numpy()
    for b in range(3):
        want = np.asarray(getattr(jaug, f"adjust_{op}")(jnp.asarray(x[b:b + 1]), factors[b]))
        np.testing.assert_allclose(got[b:b + 1], want, atol=F32_TOL)


def test_hsv_round_trip_matches():
    x = _img(6)
    np.testing.assert_allclose(augment.rgb_to_hsv(_t(x)).numpy(),
                               np.asarray(jaug.rgb_to_hsv(jnp.asarray(x))), atol=F32_TOL)
    hsv = np.asarray(jaug.rgb_to_hsv(jnp.asarray(x)))
    np.testing.assert_allclose(augment.hsv_to_rgb(_t(hsv)).numpy(),
                               np.asarray(jaug.hsv_to_rgb(jnp.asarray(hsv))), atol=F32_TOL)


def _jax_jitter(x, factors, perm):
    ops = [jaug.adjust_brightness, jaug.adjust_contrast, jaug.adjust_saturation, jaug.adjust_hue]
    out = []
    for b in range(x.shape[0]):
        y = jnp.asarray(x[b])
        for k in perm[b]:
            y = ops[k](y, factors[b, k])
        out.append(np.asarray(y))
    return np.stack(out)


def test_color_jitter_op_order_matches():
    x = _img(7)
    factors = np.float32([[1.3, 0.7, 1.2, 0.1], [0.6, 1.4, 0.5, -0.2], [1.0, 1.1, 1.3, 0.0]])
    perm = np.array([[3, 0, 2, 1], [0, 1, 2, 3], [2, 3, 1, 0]])
    got = augment.color_jitter(_t(x), _t(factors), _t(perm)).numpy()
    np.testing.assert_allclose(got, _jax_jitter(x, factors, perm), atol=F32_TOL)


def test_gaussian_blur_matches_per_sample_sigma():
    x = np.random.RandomState(8).rand(2, 12, 16, 3).astype(np.float32)
    sigma = np.float32([0.4, 1.7])
    want = np.asarray(jaug.gaussian_blur(jnp.asarray(x), jnp.asarray(sigma), 7))
    got = augment.gaussian_blur(_t(x), _t(sigma), 7).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL)


def test_strong_augment_composition_matches():
    x = _img(9)
    p = augment.StrongParams(
        factors=_t(np.float32([[1.3, 0.7, 1.2, 0.1], [0.6, 1.4, 0.5, -0.2], [1.0, 1.1, 1.3, 0.0]])),
        perm=_t(np.array([[3, 0, 2, 1], [0, 1, 2, 3], [2, 3, 1, 0]])),
        apply_jitter=_t(np.array([True, False, True])),
        apply_gray=_t(np.array([False, True, True])),
        sigma=_t(np.float32([0.5, 1.0, 1.9])),
        apply_blur=_t(np.array([True, True, False])),
    )
    got = augment.strong_augment_batch(_t(x), p, 5).numpy()
    want = np.where(p.apply_jitter.numpy()[:, None, None, None],
                    _jax_jitter(x, p.factors.numpy(), p.perm.numpy()), x)
    gray = np.broadcast_to(np.asarray(jaug.rgb_to_grayscale(jnp.asarray(want))), want.shape)
    want = np.where(p.apply_gray.numpy()[:, None, None, None], gray, want)
    blurred = np.asarray(jaug.gaussian_blur(jnp.asarray(want), jnp.asarray(p.sigma.numpy()), 5))
    want = np.where(p.apply_blur.numpy()[:, None, None, None], blurred, want)
    np.testing.assert_allclose(got, want, atol=F32_TOL)


def test_normalize_matches():
    x = _img(10)
    want = np.asarray(jaug.normalize_images(jnp.asarray(x), (0.485, 0.456, 0.406),
                                            (0.229, 0.224, 0.225), jnp.float32))
    got = augment.normalize_images(_t(x), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225),
                                   torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_samplers_respect_their_laws():
    """The sampled parameters stay in the reference's ranges (the streams
    themselves cannot match)."""
    g = torch.Generator().manual_seed(0)
    sizes = _t(np.array([[96, 96]] * 64, np.int32))
    wp = augment.sample_weak_params(g, sizes, 64, scale_min=0.5, scale_max=2.0, hflip_prob=0.5)
    assert float(wp.scale.min()) >= 0.5 and float(wp.scale.max()) <= 2.0
    sh = torch.clamp(torch.round(96 * wp.scale), min=1)
    assert bool((wp.oy >= 0).all()) and bool((wp.oy <= torch.clamp(sh - 64, min=0)).all())
    assert bool((wp.oy == wp.oy.floor()).all())
    sp = augment.sample_strong_params(g, 256, "cpu")
    assert float(sp.factors[:, :3].min()) >= 0.5 and float(sp.factors[:, :3].max()) <= 1.5
    assert float(sp.factors[:, 3].abs().max()) <= 0.25
    assert bool((sp.perm.sort(dim=1).values == torch.arange(4)).all())
    assert 0.1 <= float(sp.sigma.min()) and float(sp.sigma.max()) <= 2.0
    assert 0.6 < float(sp.apply_jitter.float().mean()) < 0.95
