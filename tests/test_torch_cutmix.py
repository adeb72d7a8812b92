"""Port's CutMix + normalize (kernel A's plain version on the CPU) against the
JAX Pallas kernel in TPU-interpret mode (ops/pallas_aug.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from semi_supervised_semantic_segmentation_tpu.ops.pallas_aug import cutmix_normalize_pallas
from semi_supervised_semantic_segmentation_tpu_torch.ops import augment
from semi_supervised_semantic_segmentation_tpu_torch.ops.cutmix_normalize import (
    cutmix_normalize,
    cutmix_normalize_triton,
)
from tests.torch_port_helpers import boxes_from_masks

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
ONE_BF16_ULP = 2.0 ** -7  # relative: the two sides may round one value differently


def _data(b=4, h=64, w=32, seed=0, distinct=False):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, h, w, 3).astype(np.float32)
    lab = rng.randint(0, 5, (b, h, w)).astype(np.int32)
    if distinct:  # every sample's labels differ from its partner's everywhere
        lab = lab * 8 + np.arange(b, dtype=np.int32)[:, None, None]
    conf = rng.rand(b, h, w) > 0.5
    return img, lab, conf


def _port(img, lab, conf, boxes):
    oi, ol, oc = cutmix_normalize(torch.from_numpy(img), torch.from_numpy(lab),
                                  torch.from_numpy(conf), torch.from_numpy(boxes), MEAN, STD)
    return oi.float().numpy(), ol.numpy(), oc.numpy()


def _jax(img, lab, conf, prob):
    oi, ol, oc = cutmix_normalize_pallas(jnp.asarray(img), jnp.asarray(lab), jnp.asarray(conf),
                                         7, prob=prob, interpret=pltpu.InterpretParams(),
                                         block_h=32)
    return np.asarray(oi, np.float32), np.asarray(ol), np.asarray(oc)


def test_prob_zero_equals_jax_kernel_normalize_only():
    img, lab, conf = _data()
    u = torch.from_numpy(np.random.RandomState(1).rand(4, 4).astype(np.float32))
    boxes = augment.cutmix_boxes(u, 64, 32, prob=0.0).numpy()
    assert not boxes.any()
    pi, pl, pc = _port(img, lab, conf, boxes)
    ji, jl, jc = _jax(img, lab, conf, 0.0)
    np.testing.assert_allclose(pi, ji, rtol=ONE_BF16_ULP, atol=0)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pc, jc)


def test_full_output_equals_jax_kernel_with_its_box():
    """The JAX kernel draws its box on chip; read it back from the mixed
    labels (partners differ everywhere), inject it into the port and
    compare all three outputs."""
    img, lab, conf = _data(distinct=True, seed=2)
    ji, jl, jc = _jax(img, lab, conf, 1.0)
    boxes = boxes_from_masks(jl != lab)
    pi, pl, pc = _port(img, lab, conf, boxes)
    np.testing.assert_allclose(pi, ji, rtol=ONE_BF16_ULP, atol=0)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pc, jc)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_box_arithmetic_matches_reference_kernel_in_numpy(prob):
    h, w = 48, 80
    u = np.random.RandomState(3).rand(64, 4).astype(np.float32)
    u[0, 0] = 0.0  # full-size cut
    u[1, 1:3] = 0.999  # centre at the far corner
    # pallas_aug.py:64-73, in float32 numpy
    lam, ucy, ucx, uprob = u.T
    ratio = np.sqrt(np.float32(1.0) - lam)
    cut_h = (ratio * np.float32(h)).astype(np.int32)
    cut_w = (ratio * np.float32(w)).astype(np.int32)
    cy = (ucy * np.float32(h)).astype(np.int32)
    cx = (ucx * np.float32(w)).astype(np.int32)
    want = np.stack([np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h),
                     np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)], 1)
    want = np.where((uprob < prob)[:, None], want, 0)
    got = augment.cutmix_boxes(torch.from_numpy(u), h, w, prob).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_injected_box_mixes_all_three_outputs():
    img, lab, conf = _data(seed=4)
    boxes = np.array([[0, 64, 0, 32], [10, 30, 5, 20], [0, 0, 0, 0], [63, 64, 31, 32]], np.int32)
    pi, pl, pc = _port(img, lab, conf, boxes)
    yy, xx = np.mgrid[0:64, 0:32]
    m = np.stack([(yy >= b[0]) & (yy < b[1]) & (xx >= b[2]) & (xx < b[3]) for b in boxes])
    mixed = np.where(m[..., None], np.roll(img, 1, 0), img)
    want = ((mixed - np.float32(MEAN)) / np.float32(STD)).astype(np.float32)
    want_bf16 = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(pi, want_bf16)
    np.testing.assert_array_equal(pl, np.where(m, np.roll(lab, 1, 0), lab))
    np.testing.assert_array_equal(pc, np.where(m, np.roll(conf, 1, 0), conf))


def test_box_is_a_rectangle_shared_by_image_labels_conf():
    img, lab, conf = _data(seed=5)
    u = torch.from_numpy(np.random.RandomState(6).rand(4, 4).astype(np.float32))
    boxes = augment.cutmix_boxes(u, 64, 32).numpy()
    pi, pl, pc = _port(img, lab, conf, boxes)
    rlab, rimg = np.roll(lab, 1, 0), np.roll(img, 1, 0)
    exp_part = (rimg - np.float32(MEAN)) / np.float32(STD)
    from_part = np.all(np.abs(pi - exp_part) <= ONE_BF16_ULP * np.abs(exp_part) + 1e-6, -1)
    changed = (pl != lab) & (lab != rlab)
    for i in range(4):
        assert np.all(from_part[i][changed[i]])
        ys, xs = np.where(changed[i])
        if len(ys):
            sub = changed[i][ys.min():ys.max() + 1, xs.min():xs.max() + 1]
            interior = (lab[i] != rlab[i])[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
            assert np.all(sub[interior])
    assert np.all((pc == conf) | (pc == np.roll(conf, 1, 0)))


def test_triton_wrapper_refuses_cpu_tensors():
    img, lab, conf = _data()
    with pytest.raises(ValueError, match="CUDA"):
        cutmix_normalize_triton(torch.from_numpy(img), torch.from_numpy(lab),
                                torch.from_numpy(conf), torch.zeros(4, 4, dtype=torch.int32),
                                MEAN, STD)
