"""The port's hand-written kernels against their plain versions on a CUDA
card, at small and ragged shapes.  Skipped without a card.  The machine with
the card has no JAX, so run these without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, stem
from semi_supervised_semantic_segmentation_tpu_torch.ops import cutmix_normalize as cmn

pytestmark = pytest.mark.cuda

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,h,w", [(2, 64, 96), (3, 30, 142)])
def test_stem_kernels_match_plain(dev, n, h, w):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand(n, h, w, 3, generator=g, device=dev) * 4 - 2).to(torch.bfloat16)
    wt = torch.randn(64, 3, 7, 7, generator=g, device=dev) * 0.05
    y, s = stem.stem_fwd(x, wt)
    yp, sp = stem.stem_fwd_plain(x, wt)
    torch.cuda.synchronize()
    # one bf16 rounding of f32 sums taken in another order: one ulp
    assert bool(((y.float() - yp.float()).abs() <= 2.0 ** -7 * yp.float().abs() + 1e-4).all())
    torch.testing.assert_close(s, sp, rtol=1e-3, atol=1e-3 * sp.abs().max().item())
    dy = (torch.randn(y.shape, generator=g, device=dev) * 1e-2).to(torch.bfloat16)
    ds = torch.randn(2, 64, generator=g, device=dev) * 1e-3
    dw = stem.stem_dw(x, dy, y, ds, 7)
    dwp = stem.stem_dw_plain(x, dy, y, ds, 7)
    assert (dw - dwp).abs().max().item() <= 1e-3 * dwp.abs().max().item()


def test_stem_kernel_refuses_what_it_does_not_take(dev):
    w = torch.zeros(7, 7, 3, 64, device=dev)
    with pytest.raises(ValueError):
        stem.stem_fwd_cuda(torch.zeros(1, 16, 16, 3, device=dev), w)  # f32 input
    with pytest.raises(ValueError):
        stem.stem_fwd_cuda(torch.zeros(1, 15, 16, 3, device=dev, dtype=torch.bfloat16), w)


@pytest.mark.parametrize("b,h,w", [(4, 64, 64), (3, 37, 100)])
def test_cutmix_normalize_kernel_matches_plain(dev, b, h, w):
    g = torch.Generator(device=dev).manual_seed(1)
    imgs = torch.rand(b, h, w, 3, generator=g, device=dev)
    labs = torch.randint(0, 21, (b, h, w), generator=g, device=dev, dtype=torch.int32)
    conf = torch.rand(b, h, w, generator=g, device=dev) > 0.5
    boxes = augment.cutmix_boxes(torch.rand(b, 4, generator=g, device=dev), h, w, 1.0)
    oi, ol, oc = cmn.cutmix_normalize(imgs, labs, conf, boxes, MEAN, STD, torch.bfloat16)
    pi, pl, pc = cmn.cutmix_normalize_plain(imgs, labs, conf, boxes, MEAN, STD, torch.bfloat16)
    assert bool(((oi.float() - pi.float()).abs() <= 2.0 ** -7 * pi.float().abs() + 1e-6).all())
    assert torch.equal(ol, pl) and torch.equal(oc, pc)
