"""The port's hand-written kernels against their plain versions on a CUDA
card, at small and ragged shapes.  Skipped without a card.  The machine with
the card has no JAX, so run these without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from semi_supervised_semantic_segmentation_tpu_torch.ops import augment, stem
from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv as bc
from semi_supervised_semantic_segmentation_tpu_torch.ops import cutmix_normalize as cmn

pytestmark = pytest.mark.cuda

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' f32 convolutions in full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stem_inputs(dev, n, h, w, k):
    g = torch.Generator(device=dev).manual_seed(k)
    x = (torch.rand(n, h, w, 3, generator=g, device=dev) * 4 - 2).to(torch.bfloat16)
    wt = torch.randn(64, 3, k, k, generator=g, device=dev) * (0.35 / k)
    dy = (torch.randn(n, 64, h // 2, w // 2, generator=g, device=dev) * 1e-2).to(torch.bfloat16)
    ds = torch.randn(2, 64, generator=g, device=dev) * 1e-3
    return x, wt, dy, ds


# config 3's two calls (teacher N = 8, student N = 16 at 512^2), the two
# small shapes (W = 142: the synchronous fill and scalar stores, a ragged
# column tile, an odd number of output rows), and every odd k the kernels take
@pytest.mark.parametrize("n,h,w,k", [(2, 64, 96, 7), (3, 30, 142, 7), (8, 512, 512, 7),
                                     (16, 512, 512, 7), (2, 64, 96, 1), (2, 64, 96, 3),
                                     (2, 64, 96, 5), (2, 64, 96, 9), (2, 64, 96, 11),
                                     (3, 30, 142, 3), (3, 30, 142, 11)])
def test_stem_kernels_match_plain(dev, n, h, w, k):
    x, wt, dy, ds = _stem_inputs(dev, n, h, w, k)
    vec = stem.stem_vec(x.shape, (x.data_ptr(), dy.data_ptr()))
    before = (stem.stem_fwd_cuda.launches_vec, stem.stem_dw_cuda.launches_vec)
    y, s = stem.stem_fwd(x, wt)
    yp, sp = stem.stem_fwd_plain(x, wt)
    torch.cuda.synchronize()
    # one bf16 rounding of f32 sums taken in another order: one ulp
    assert _within_one_ulp(y, yp), (y.float() - yp.float()).abs().max().item()
    # each row within 1e-3 of its largest magnitude: sums over up to 4M
    # values in another order, a few y one ulp away
    assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())
    dw = stem.stem_dw(x, dy, y, ds, k)
    dwp = stem.stem_dw_plain(x, dy, y, ds, k)
    # f32 sums over up to 1M pixels in another order
    assert (dw - dwp).abs().max().item() <= 1e-3 * dwp.abs().max().item()
    assert (stem.stem_fwd_cuda.launches_vec - before[0],
            stem.stem_dw_cuda.launches_vec - before[1]) == (int(vec), int(vec))


@pytest.mark.parametrize("n,h,w", [(2, 64, 96), (3, 30, 142)])
def test_stem_kernels_are_deterministic(dev, n, h, w):
    """Fixed-order partials, no atomics: the same inputs give the same bits."""
    x, wt, dy, ds = _stem_inputs(dev, n, h, w, 7)
    y1, s1 = stem.stem_fwd(x, wt)
    y2, s2 = stem.stem_fwd(x, wt)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    assert torch.equal(stem.stem_dw(x, dy, y1, ds, 7), stem.stem_dw(x, dy, y1, ds, 7))


def test_stem_copy_paths_agree(dev):
    """A misaligned x takes the synchronous fill: the same bits as the copies."""
    x, wt, dy, ds = _stem_inputs(dev, 2, 64, 96, 7)
    xm = _misaligned(x)
    assert stem.stem_vec(x.shape, (x.data_ptr(),)) and not stem.stem_vec(xm.shape, (xm.data_ptr(),))
    y, s = stem.stem_fwd(x, wt)
    ym, sm = stem.stem_fwd(xm, wt)
    assert torch.equal(y, ym) and torch.equal(s, sm)
    assert torch.equal(stem.stem_dw(x, dy, y, ds, 7), stem.stem_dw(xm, dy, y, ds, 7))


def test_stem_kernel_refuses_what_it_does_not_take(dev):
    w = torch.zeros(7, 7, 3, 64, device=dev)
    bf = torch.bfloat16
    with pytest.raises(ValueError):
        stem.stem_fwd_cuda(torch.zeros(1, 16, 16, 3, device=dev), w)  # f32 input
    with pytest.raises(ValueError):
        stem.stem_fwd_cuda(torch.zeros(1, 15, 16, 3, device=dev, dtype=bf), w)
    with pytest.raises(ValueError):  # k = 13
        stem.stem_fwd_cuda(torch.zeros(1, 16, 16, 3, device=dev, dtype=bf),
                           torch.zeros(13, 13, 3, 64, device=dev))
    with pytest.raises(ValueError):  # even k
        stem.stem_fwd_cuda(torch.zeros(1, 16, 16, 3, device=dev, dtype=bf),
                           torch.zeros(4, 4, 3, 64, device=dev))
    x = torch.zeros(1, 16, 16, 3, device=dev, dtype=bf)
    y = torch.zeros(1, 64, 8, 8, device=dev, dtype=bf)
    with pytest.raises(ValueError):  # dy of the wrong shape
        stem.stem_dw_cuda(x, torch.zeros(1, 64, 8, 7, device=dev, dtype=bf), y,
                          torch.zeros(2, 64, device=dev), 7)
    with pytest.raises(ValueError):  # ds in bf16
        stem.stem_dw_cuda(x, y, y, torch.zeros(2, 64, device=dev, dtype=bf), 7)


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


def _within_one_ulp(got, want):
    """bf16 roundings of f32 sums taken in another order: one ulp apart."""
    return bool(((got.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs() + 1e-4).all())


def _branch_inputs(dev, n, c, h, w):
    g = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn(n, c, h, w, generator=g, device=dev).to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, generator=g, device=dev) / (3.0 * c ** 0.5)
    mul = torch.rand(c, generator=g, device=dev) + 0.5
    add = torch.randn(c, generator=g, device=dev) * 0.1
    dy = (torch.randn(n, c, h, w, generator=g, device=dev) * 1e-2).to(torch.bfloat16)
    ds = torch.randn(2, c, generator=g, device=dev) * 1e-3
    return x, wt, mul, add, dy, ds


@pytest.mark.parametrize("n,c,h,w", [(2, 8, 32, 40), (2, 16, 16, 24), (2, 48, 32, 70),
                                     (1, 96, 64, 33), (1, 128, 32, 20), (2, 48, 32, 40),
                                     (1, 96, 32, 72)])
def test_branch_conv_kernels_match_plain(dev, n, c, h, w):
    """D (plain, pre, flipped dx conv) and E (fused dY with ds != 0, with and
    without pre; unfused) against their plain versions, at widths that pad
    to the MMA's 16 and at W not a multiple of the 32-pixel tile.  E takes
    E96 at C = 96 and E48 at C = 48 with W % 8 == 0, else its asynchronous
    ring exactly when W % 8 == 0: W = 40 and 72 end in a ragged column tile
    (dY beyond W must stay 0, not ds0), and C = 96 at H = 32 with pre puts
    the input's zero halo (not relu(add)) at both the top and the bottom of
    the image."""
    x, wt, mul, add, dy, ds = _branch_inputs(dev, n, c, h, w)
    e96 = bc.dw_c96(x.shape, (x.data_ptr(), dy.data_ptr()))
    e48 = bc.dw_c48(x.shape, (x.data_ptr(), dy.data_ptr()))
    ring = w % 8 == 0 and not e96 and not e48
    for pre in ((), (mul, add)):
        y, s = bc.conv3x3_fwd(x, wt, *pre)
        yp, sp = bc.conv3x3_fwd_plain(x, wt, *pre)
        torch.cuda.synchronize()
        assert _within_one_ulp(y, yp), (pre != (), (y.float() - yp.float()).abs().max().item())
        assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())
        f = bc.conv3x3_dw_cuda
        before = (f.launches_async, f.launches_c96, f.launches_c48)
        dk, dY = bc.conv3x3_dw(x, dy, y, ds, *pre)
        assert (f.launches_async - before[0], f.launches_c96 - before[1],
                f.launches_c48 - before[2]) == (int(ring), int(e96), int(e48))
        dkp, dYp = bc.conv3x3_dw_plain(x, dy, y, ds, *pre)
        assert torch.equal(dY, dYp)
        assert (dk - dkp).abs().max().item() <= 1e-3 * dkp.abs().max().item()
    dx, none = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)
    assert none is None
    assert _within_one_ulp(dx, bc.conv3x3_fwd_plain(dy, wt, stats=False, flip=True)[0])
    dk, dY = bc.conv3x3_dw(x, dy)
    assert dY is None
    dkp = bc.conv3x3_dw_plain(x, dy)[0]
    assert (dk - dkp).abs().max().item() <= 1e-3 * dkp.abs().max().item()


def _misaligned(t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def test_branch_conv_dw_misaligned_input_takes_the_synchronous_fill(dev):
    """W % 8 == 0, but x starts off a 16-byte boundary: E fills its tiles
    synchronously (neither E48's counter nor the ring's moves), matches the
    plain version, and gives the ring's bits."""
    x, wt, mul, add, dy, ds = _branch_inputs(dev, 2, 48, 32, 64)
    y = bc.conv3x3_fwd(x, wt, mul, add)[0]
    xm = _misaligned(x)
    f = bc.conv3x3_dw_cuda
    before, before_async, before_c48 = f.launches, f.launches_async, f.launches_c48
    dk, dY = bc.conv3x3_dw(xm, dy, y, ds, mul, add)
    torch.cuda.synchronize()
    assert f.launches == before + 1
    assert (f.launches_async, f.launches_c48) == (before_async, before_c48)
    dkp, dYp = bc.conv3x3_dw_plain(x, dy, y, ds, mul, add)
    assert torch.equal(dY, dYp)
    assert (dk - dkp).abs().max().item() <= 1e-3 * dkp.abs().max().item()
    # the ring on the aligned input (named: the wrapper takes E48 there)
    # walks the same tiles through the same products, so its staging must
    # give the same bits of dk and dY
    dk2, dY2, _ = bc.conv3x3_dw_launch(x, dy, y, ds, mul, add, kernel="ring")
    assert f.launches_async == before_async + 1
    assert torch.equal(dY2, dYp) and torch.equal(dk2, dk)


@pytest.mark.parametrize("n,c,h,w", [(2, 48, 32, 64), (1, 96, 32, 72), (1, 96, 64, 33)])
def test_branch_conv_dw_is_deterministic(dev, n, c, h, w):
    """Two launches on the same inputs give the same bits of dk and dY (the
    partials are summed in a fixed order; no atomics), on either path."""
    x, wt, mul, add, dy, ds = _branch_inputs(dev, n, c, h, w)
    y = bc.conv3x3_fwd(x, wt, mul, add)[0]
    dk1, dY1 = bc.conv3x3_dw(x, dy, y, ds, mul, add)
    dk2, dY2 = bc.conv3x3_dw(x, dy, y, ds, mul, add)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dY1, dY2)


def test_branch_conv_autograd_on_the_card_matches_the_cpu(dev):
    """The fused op's four gradients through kernels D and E (the backward
    in D's post mode, counted) against the same op on the CPU's plain
    versions."""
    torch.manual_seed(0)
    c = 16
    x = torch.randn(2, c, 32, 24).to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3) * 0.1
    mul, add = torch.rand(c) + 0.5, torch.randn(c) * 0.1
    co, ws = torch.randn(2, c, 32, 24), torch.randn(2, c) * 0.1
    grads = []
    before = bc.conv3x3_fwd_cuda.launches_post
    for where in (dev, "cpu"):
        args = [t.to(where).requires_grad_() for t in (x, wt, mul, add)]
        y, s = bc.conv3x3_bn_nchw(*args)
        ((y.float() * co.to(where)).sum() + (s * ws.to(where)).sum()).backward()
        grads.append([a.grad.float().cpu() for a in args])
    assert bc.conv3x3_fwd_cuda.launches_post == before + 1
    for name, a, b in zip(("dx", "dk", "dmul", "dadd"), *grads):
        assert (a - b).abs().max().item() <= 2e-2 * b.abs().max().item(), name


@pytest.mark.parametrize("n,c,h,w", [(2, 48, 32, 40), (1, 96, 32, 72), (2, 16, 32, 24),
                                     (1, 96, 64, 33)])
def test_branch_conv_dx_post_matches_plain(dev, n, c, h, w):
    """D's post mode (the dx conv with the input transform's backward in its
    epilogue) at a ragged last column tile (W = 40, 33), at C = 96 with
    H = 32 and at a width that pads to 16: dx bit-equal to D's dx conv
    followed by pre_backward on the card, and over two launches; against the
    plain version dx within dt's one ulp carried through the scale plus
    dx's own rounding, (dmul, dadd) within 1e-3 of each row's max.  Each
    launch counts once in ``launches`` and once in ``launches_post``."""
    x, wt, mul, add, dy, _ = _branch_inputs(dev, n, c, h, w)
    before, before_post = bc.conv3x3_fwd_cuda.launches, bc.conv3x3_fwd_cuda.launches_post
    dx, s = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    dx2, s2 = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    torch.cuda.synchronize()
    assert bc.conv3x3_fwd_cuda.launches == before + 2
    assert bc.conv3x3_fwd_cuda.launches_post == before_post + 2
    assert torch.equal(dx, dx2) and torch.equal(s, s2)
    dt = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)[0]
    assert torch.equal(dx, bc.pre_backward(x, dt, mul, add)[0])
    dxp, sp = bc.conv3x3_dx_post_plain(dy, wt, x, mul, add)
    assert bool(((dx.float() - dxp.float()).abs() <= 2.0 ** -6 * dxp.float().abs() + 1e-4).all())
    assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())


@pytest.mark.parametrize("n,c,h,w", [(2, 96, 32, 64), (1, 96, 64, 72), (1, 88, 32, 64)])
def test_d96_matches_plain_in_every_mode(dev, n, c, h, w):
    """D96 (C padding to 96, W % 8 == 0, aligned) in every mode against the
    plain versions: y within one bf16 ulp, the statistics within 1e-3 of
    each row's max; post bit-equal to D96's own dx conv followed by
    pre_backward, and over two launches.  Every launch is counted in
    ``launches_c96`` (post ones also in ``launches_c96_post``).  W = 72 ends
    in a ragged column tile; C = 88 pads to 96 (rows and channels >= C by
    position); H = 32 puts the zero halo at the top and bottom."""
    x, wt, mul, add, dy, _ = _branch_inputs(dev, n, c, h, w)
    f = bc.conv3x3_fwd_cuda
    for pre in ((), (mul, add)):
        before = f.launches_c96
        y, s = bc.conv3x3_fwd(x, wt, *pre)
        assert f.launches_c96 == before + 1
        yp, sp = bc.conv3x3_fwd_plain(x, wt, *pre)
        torch.cuda.synchronize()
        assert _within_one_ulp(y, yp), (pre != (), (y.float() - yp.float()).abs().max().item())
        assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())
    before = f.launches_c96
    dt, none = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)
    assert none is None and f.launches_c96 == before + 1
    assert _within_one_ulp(dt, bc.conv3x3_fwd_plain(dy, wt, stats=False, flip=True)[0])
    before, before_post = f.launches_c96, f.launches_c96_post
    dx, s = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    dx2, s2 = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    torch.cuda.synchronize()
    assert f.launches_c96 == before + 2 and f.launches_c96_post == before_post + 2
    assert torch.equal(dx, dx2) and torch.equal(s, s2)
    assert torch.equal(dx, bc.pre_backward(x, dt, mul, add)[0])
    dxp, sp = bc.conv3x3_dx_post_plain(dy, wt, x, mul, add)
    assert bool(((dx.float() - dxp.float()).abs() <= 2.0 ** -6 * dxp.float().abs() + 1e-4).all())
    assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())


@pytest.mark.parametrize("n,c,h,w,shift", [(1, 96, 32, 64, True), (1, 96, 32, 33, False),
                                           (2, 48, 32, 64, True), (2, 48, 32, 70, False)])
def test_d_outside_d96_takes_conv_fwd_kernel(dev, n, c, h, w, shift):
    """A misaligned copy of x, or W % 8 != 0, takes conv_fwd_kernel (the
    D96 and D48 counters stay put) in every mode and matches the plain
    version, at C = 96 and at C = 48."""
    x, wt, mul, add, dy, _ = _branch_inputs(dev, n, c, h, w)
    if shift:
        x, dy = _misaligned(x), _misaligned(dy)
    f = bc.conv3x3_fwd_cuda
    before, before96, before48 = f.launches, f.launches_c96, f.launches_c48
    y, s = bc.conv3x3_fwd(x, wt, mul, add)
    dt = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)[0]
    dx, sd = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    torch.cuda.synchronize()
    assert f.launches == before + 3 and f.launches_c96 == before96 and f.launches_c48 == before48
    yp, sp = bc.conv3x3_fwd_plain(x, wt, mul, add)
    assert _within_one_ulp(y, yp)
    assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())
    assert _within_one_ulp(dt, bc.conv3x3_fwd_plain(dy, wt, stats=False, flip=True)[0])
    assert torch.equal(dx, bc.pre_backward(x, dt, mul, add)[0])


@pytest.mark.parametrize("c,flip", [(96, False), (96, True), (88, True), (48, False), (48, True),
                                    (40, True)])
def test_d96_packed_weights_equal_the_plain_pack(dev, c, flip):
    """The pack kernels of D96 and of D48 write flip_weight(w).to(bf16) (or
    w) tap-major in their layouts, zero beyond C (and, at 48, in the skew):
    the plain pack, bit for bit."""
    wt = _branch_inputs(dev, 1, c, 8, 8)[1]
    assert torch.equal(bc.pack_weights_cuda(wt, flip), bc.pack_weights_plain(wt, flip))


# config 5's branch 0, a width that pads to 48, a ragged last column tile
D48_SHAPES = [(8, 48, 256, 256), (2, 40, 32, 64), (2, 48, 32, 40)]


@pytest.mark.parametrize("n,c,h,w", D48_SHAPES)
def test_d48_matches_plain_in_every_mode(dev, n, c, h, w):
    """D48 (C padding to 48, W % 8 == 0, aligned) in every mode against the
    plain versions: y within one bf16 ulp, the statistics within 1e-3 of
    each row's max; post bit-equal to D48's own dx conv followed by
    pre_backward.  Two launches give the same bits (y and the [2,C] sums:
    fixed-order partials).  Every launch is counted in ``launches_c48``
    (post ones also in ``launches_c48_post``), none in D96's."""
    x, wt, mul, add, dy, _ = _branch_inputs(dev, n, c, h, w)
    f = bc.conv3x3_fwd_cuda
    for pre in ((), (mul, add)):
        before, before96 = f.launches_c48, f.launches_c96
        y, s = bc.conv3x3_fwd(x, wt, *pre)
        y2, s2 = bc.conv3x3_fwd(x, wt, *pre)
        assert f.launches_c48 == before + 2 and f.launches_c96 == before96
        yp, sp = bc.conv3x3_fwd_plain(x, wt, *pre)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(s, s2)
        assert _within_one_ulp(y, yp), (pre != (), (y.float() - yp.float()).abs().max().item())
        assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())
    before = f.launches_c48
    dt, none = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)
    assert none is None and f.launches_c48 == before + 1
    assert torch.equal(dt, bc.conv3x3_fwd(dy, wt, stats=False, flip=True)[0])
    assert _within_one_ulp(dt, bc.conv3x3_fwd_plain(dy, wt, stats=False, flip=True)[0])
    before, before_post = f.launches_c48, f.launches_c48_post
    dx, s = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    dx2, s2 = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    torch.cuda.synchronize()
    assert f.launches_c48 == before + 2 and f.launches_c48_post == before_post + 2
    assert torch.equal(dx, dx2) and torch.equal(s, s2)
    assert torch.equal(dx, bc.pre_backward(x, dt, mul, add)[0])
    dxp, sp = bc.conv3x3_dx_post_plain(dy, wt, x, mul, add)
    assert bool(((dx.float() - dxp.float()).abs() <= 2.0 ** -6 * dxp.float().abs() + 1e-4).all())
    assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())


@pytest.mark.parametrize("n,c,h,w", D48_SHAPES)
def test_d48_is_bit_equal_to_conv_fwd_kernel(dev, n, c, h, w):
    """Misaligned copies of the inputs take conv_fwd_kernel; D48 keeps its k
    order and MMA shape, so y, the dx conv and post's dx are bit-equal to
    it, and the [2,C] sums agree within f32 reordering (1e-3 of each row's
    max, the bound against the plain version)."""
    x, wt, mul, add, dy, _ = _branch_inputs(dev, n, c, h, w)
    xm, dym = _misaligned(x), _misaligned(dy)
    f = bc.conv3x3_fwd_cuda
    for pre in ((), (mul, add)):
        y, s = bc.conv3x3_fwd(x, wt, *pre)
        before = f.launches_c48
        yo, so = bc.conv3x3_fwd(xm, wt, *pre)
        torch.cuda.synchronize()
        assert f.launches_c48 == before
        assert torch.equal(y, yo), (pre != (), (y.float() - yo.float()).abs().max().item())
        assert bool(((s - so).abs() <= 1e-3 * so.abs().amax(dim=1, keepdim=True)).all())
    dt = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)[0]
    assert torch.equal(dt, bc.conv3x3_fwd(dym, wt, stats=False, flip=True)[0])
    dx, s = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    dxo, so = bc.conv3x3_dx_post(dym, wt, xm, mul, add)
    torch.cuda.synchronize()
    assert torch.equal(dx, dxo)
    assert bool(((s - so).abs() <= 1e-3 * so.abs().amax(dim=1, keepdim=True)).all())


def test_d_at_an_eval_shape_matches_plain(dev):
    """D in ``pre`` mode at one of config 5's eval shapes (branch 0 of a
    768^2 window, 16 windows in a batch): y within one bf16 ulp of the
    plain version, the statistics within 1e-3 of each row's max.  Prints
    the kernel ``fwd_kernel`` picks (48: D48, 96: D96, 0: conv_fwd_kernel)."""
    x, wt, mul, add, _, _ = _branch_inputs(dev, 16, 48, 192, 192)
    kern = bc.fwd_kernel(x.shape, (x.data_ptr(), x.data_ptr()))
    print(f"fwd_kernel at {tuple(x.shape)}: {kern}")
    y, s = bc.conv3x3_fwd(x, wt, mul, add)
    yp, sp = bc.conv3x3_fwd_plain(x, wt, mul, add)
    torch.cuda.synchronize()
    assert _within_one_ulp(y, yp), (y.float() - yp.float()).abs().max().item()
    assert bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())


def test_branch_conv_kernels_refuse_what_they_do_not_take(dev):
    w = torch.zeros(8, 8, 3, 3, device=dev)
    with pytest.raises(ValueError):
        bc.conv3x3_fwd_cuda(torch.zeros(1, 8, 32, 16, device=dev), w)  # f32 input
    with pytest.raises(ValueError):
        bc.conv3x3_fwd_cuda(torch.zeros(1, 8, 12, 16, device=dev, dtype=torch.bfloat16), w)
    with pytest.raises(ValueError):
        bc.conv3x3_fwd_cuda(torch.zeros(1, 144, 32, 16, device=dev, dtype=torch.bfloat16),
                            torch.zeros(144, 144, 3, 3, device=dev))
    dY = torch.zeros(1, 8, 32, 16, device=dev, dtype=torch.bfloat16)
    v = torch.ones(8, device=dev)
    with pytest.raises(ValueError):  # x of another shape than dY
        bc.conv3x3_dx_post_cuda(dY, w, dY[:, :, :16], v, v)
    with pytest.raises(ValueError):  # mul of another width
        bc.conv3x3_dx_post_cuda(dY, w, dY, torch.ones(4, device=dev), v)
