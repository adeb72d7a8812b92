"""D96, kernel D at channels that pad to 96 (``conv_d96_kernel``).

On the CPU: the x operand's addressing that the wrapper hands the kernel
(:func:`d96_operand_plan`), held to the im2col of every tap over an operand
packed here with numpy as the kernel's producer packs it (column runs past
W included), and the wrapper's plain version on CPU tensors.  On a CUDA
card (``cuda`` marker; skipped here): D96 against the plain versions in
all four modes (the dx conv, statistics, ``pre`` + statistics, ``post``) at
small shapes that reach every edge, bit-equal over two launches, the
routing of a misaligned input to ``conv_fwd_kernel``, and the stamps.  The
machine with the card has no JAX; run the card's tests without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_d96.py
"""

import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv as bc


def _bits(t: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> its uint16 codes."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _pack_operand(t: np.ndarray, c: int, oy0: int, ox0: int, plan: dict) -> np.ndarray:
    """The x operand of the tile at (oy0, ox0) of image t [C, H, W] (uint16
    bf16 codes of the transformed input), as the kernel's producer writes
    it: channel group g, halo row r, column c at g * plane + r * row + c * 16
    bytes, 8 channels of one pixel; 0 outside the image and past C."""
    rows, cols = plan["halo"]
    buf = np.zeros(plan["channel_groups"] * plan["plane"] // 2, np.uint16)
    _, h, w = t.shape
    for g in range(plan["channel_groups"]):
        for r in range(rows):
            iy = oy0 - 1 + r
            for col in range(cols):
                ix = ox0 - 1 + col
                if not (0 <= iy < h and 0 <= ix < w):
                    continue
                at = (g * plan["plane"] + r * plan["row"] + col * plan["pixel"]) // 2
                for e in range(8):
                    if 8 * g + e < c:
                        buf[at + e] = t[8 * g + e, iy, ix]
    return buf


@pytest.mark.parametrize("c,w", [(96, 64), (96, 96), (88, 128), (96, 40)])
def test_d96_operand_addressing_is_im2col(c, w):
    """Every tile's x operand read through the wgmma descriptors the kernel
    builds from d96_operand_plan (start tap[kh*3 + kw] + rr * row + 2 * s *
    plane for tile row rr and k16 step s; then 8-pixel groups sbo apart, 16
    bytes a pixel, the two 8-channel halves lbo apart) is the im2col of that
    tap: A[m, k] = t[16 s + k, oy0 + rr + kh - 1, ox0 + m + kw - 1], 0 in the
    SAME padding and past C.  W = 96 and 40 end in a column run that is
    partly past W (its outputs are masked; its operand is the zero padding)."""
    plan = bc.d96_operand_plan()
    assert plan["row"] % 32 == 16  # an odd pitch of 16-byte pixels
    assert plan["sbo"] == 128 and plan["lbo"] == plan["plane"]
    rows, cols = bc.D96_TILE
    assert plan["halo"] == (rows + 2, cols + 2)
    for tap in plan["tap"]:
        assert tap + (rows - 1) * plan["row"] + cols * plan["pixel"] <= plan["plane"]
    g = torch.Generator().manual_seed(c + w)
    h = 8
    x = torch.randn(1, c, h, w, generator=g).to(torch.bfloat16)
    mul, add = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    t = bc.transform_input(x, mul, add)[0]
    codes = _bits(t)
    tp = np.zeros((96, h + 2, w + cols + 2), np.uint16)  # SAME padding, channels past C
    tp[:c, 1:h + 1, 1:w + 1] = codes
    m = np.arange(cols)[:, None]
    kk = np.arange(16)[None, :]
    for oy0 in range(0, h, rows):
        for ox0 in range(0, w, cols):
            buf = _pack_operand(codes, c, oy0, ox0, plan)
            for rr in range(rows):
                for tap, off in enumerate(plan["tap"]):
                    kh, kw = divmod(tap, 3)
                    for s in range(96 // 16):
                        start = off + rr * plan["row"] + 2 * s * plan["plane"]
                        byte = (start + (m // 8) * plan["sbo"] + (m % 8) * plan["pixel"]
                                + (kk // 8) * plan["lbo"] + (kk % 8) * 2)
                        a = buf[byte // 2]
                        want = tp[16 * s + kk, oy0 + rr + kh, ox0 + m + kw]
                        np.testing.assert_array_equal(a, want, err_msg=f"tile ({oy0}, {ox0}) "
                                                      f"row {rr} tap {tap} step {s}")


def test_d96_ops_are_the_plan():
    """The int[11] the wrapper hands the kernel is d96_operand_plan's plane,
    row and nine tap offsets."""
    plan = bc.d96_operand_plan()
    assert list(bc._d96_ops()) == [plan["plane"], plan["row"], *plan["tap"]]


def test_d96_on_cpu_takes_the_plain_version():
    """A CPU tensor never reaches a kernel: conv3x3_fwd and conv3x3_dx_post
    at C = 88 are their plain versions, and no counter moves."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 88, 8, 40, generator=g).to(torch.bfloat16)
    dy = torch.randn(1, 88, 8, 40, generator=g).to(torch.bfloat16)
    w = torch.randn(88, 88, 3, 3, generator=g) * 0.05
    mul, add = torch.rand(88, generator=g) + 0.5, torch.randn(88, generator=g) * 0.1
    f = bc.conv3x3_fwd_cuda
    before = (f.launches, f.launches_c96, f.launches_c96_post)
    y, s = bc.conv3x3_fwd(x, w, mul, add)
    yp, sp = bc.conv3x3_fwd_plain(x, w, mul, add)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    dx, ds = bc.conv3x3_dx_post(dy, w, x, mul, add)
    dxp, dsp = bc.conv3x3_dx_post_plain(dy, w, x, mul, add)
    assert torch.equal(dx, dxp) and torch.equal(ds, dsp)
    assert (f.launches, f.launches_c96, f.launches_c96_post) == before


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' f32 convolutions in full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, c, h, w, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g, device=dev).to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, generator=g, device=dev) / (3.0 * c ** 0.5)
    mul = torch.rand(c, generator=g, device=dev) + 0.5
    add = torch.randn(c, generator=g, device=dev) * 0.1
    dy = (torch.randn(n, c, h, w, generator=g, device=dev) * 1e-2).to(torch.bfloat16)
    return x, wt, mul, add, dy


def _within_one_ulp(a, b):
    return bool(((a.float() - b.float()).abs() <= 2.0 ** -7 * b.float().abs() + 1e-4).all())


def _stats_ok(s, sp):
    return bool(((s - sp).abs() <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all())


def _misaligned(t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


# one image and two; W = 64 (one whole column run), 96 and 40 (a run partly
# past W), 128 (two runs); C = 88 (channels and C_out past C by position);
# H = 8 and 16 (halos at the top and bottom, 2 and 4 tile rows)
D96_SHAPES = [(1, 96, 8, 64), (2, 96, 8, 96), (1, 96, 16, 128), (2, 88, 8, 40), (1, 88, 8, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", D96_SHAPES)
@pytest.mark.parametrize("mode", ["dx", "stats", "pre+stats", "post"])
def test_d96_matches_plain(dev, n, c, h, w, mode):
    """D96 in each mode against the plain version: y (dx, dt) within one
    bf16 ulp, the statistics within 1e-3 of each row's max; post's dx within
    one ulp of dt through the scale plus its own rounding (2^-6 relative)
    and bit-equal to D96's own dx conv followed by pre_backward.  Counted in
    launches_c96 (post also in launches_c96_post), two launches bit-equal."""
    x, wt, mul, add, dy = _inputs(dev, n, c, h, w)
    f = bc.conv3x3_fwd_cuda
    before = (f.launches_c96, f.launches_c96_post)
    if mode == "post":
        out = [bc.conv3x3_dx_post(dy, wt, x, mul, add) for _ in range(2)]
        torch.cuda.synchronize()
        assert (f.launches_c96 - before[0], f.launches_c96_post - before[1]) == (2, 2)
        dt = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)[0]
        assert torch.equal(out[0][0], bc.pre_backward(x, dt, mul, add)[0])
        want, sp = bc.conv3x3_dx_post_plain(dy, wt, x, mul, add)
        err = (out[0][0].float() - want.float()).abs()
        assert bool((err <= 2.0 ** -6 * want.float().abs() + 1e-4).all()), err.max().item()
    else:
        src, pre, stats, flip = {"dx": (dy, (), False, True), "stats": (x, (), True, False),
                                 "pre+stats": (x, (mul, add), True, False)}[mode]
        out = [bc.conv3x3_fwd(src, wt, *pre, stats=stats, flip=flip) for _ in range(2)]
        torch.cuda.synchronize()
        assert (f.launches_c96 - before[0], f.launches_c96_post - before[1]) == (2, 0)
        want, sp = bc.conv3x3_fwd_plain(src, wt, *pre, stats=stats, flip=flip)
        assert _within_one_ulp(out[0][0], want), (out[0][0].float() - want.float()).abs().max()
    assert torch.equal(out[0][0], out[1][0])
    assert (out[0][1] is None) == (sp is None)
    if sp is not None:
        assert torch.equal(out[0][1], out[1][1]) and _stats_ok(out[0][1], sp)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", [(1, 96, 8, 64), (2, 88, 8, 40)])
def test_d96_misaligned_input_takes_conv_fwd_kernel(dev, n, c, h, w):
    """x (or dY and post's x) 2 bytes past a 16-byte boundary: every mode
    runs on conv_fwd_kernel (D's counter moves, D96's does not) and agrees
    with D96 within one bf16 ulp (statistics within 1e-3 of each row's max)."""
    x, wt, mul, add, dy = _inputs(dev, n, c, h, w, seed=1)
    xm, dym = _misaligned(x), _misaligned(dy)
    f = bc.conv3x3_fwd_cuda
    y, s = bc.conv3x3_fwd(x, wt, mul, add)
    dt = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)[0]
    dx, sd = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    before = (f.launches, f.launches_c96, f.launches_c48)
    yo, so = bc.conv3x3_fwd(xm, wt, mul, add)
    dto = bc.conv3x3_fwd(dym, wt, stats=False, flip=True)[0]
    dxo, sdo = bc.conv3x3_dx_post(dym, wt, xm, mul, add)
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.launches_c96 - before[1], f.launches_c48 - before[2]) == (
        3, 0, 0)
    assert _within_one_ulp(y, yo) and _within_one_ulp(dt, dto) and _stats_ok(s, so)
    assert bool(((dx.float() - dxo.float()).abs() <= 2.0 ** -6 * dxo.float().abs() + 1e-4).all())
    assert _stats_ok(sd, sdo)


@pytest.mark.cuda
@pytest.mark.parametrize("post", [False, True])
def test_d96_stamps(dev, post):
    """D96's stamps: one row per CTA (as many as tiles here), every tile
    loop and x fill non-empty, the loop no shorter than its consumer's
    phases, the global timer's marks in order (start, loop start, loop end,
    end), and the launch's output the same bits as a launch without
    stamps."""
    x, wt, mul, add, dy = _inputs(dev, 2, 96, 8, 96, seed=3)
    if post:
        dx, s, cyc = bc.conv3x3_dx_post_cuda(dy, wt, x, mul, add, cycles=True)
        want = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    else:
        dx, s, cyc = bc.conv3x3_fwd_cuda(x, wt, mul, add, cycles=True)
        want = bc.conv3x3_fwd(x, wt, mul, add)
    torch.cuda.synchronize()
    assert cyc.shape == (2 * 2 * 2, len(bc.D96_PHASES)) and len(bc.D96_PHASES) == 12
    assert bool((cyc[:, 7] > 0).all()) and bool((cyc[:, 1] > 0).all())
    assert bool((cyc[:, :8] >= 0).all())
    assert bool((cyc[:, 3:7].sum(dim=1) <= cyc[:, 7]).all())
    assert bool((cyc[:, 9:12] >= cyc[:, 8:11]).all())
    assert torch.equal(dx, want[0]) and torch.equal(s, want[1])


@pytest.mark.cuda
def test_d96_refuses_stamps_elsewhere(dev):
    """Stamps are D96's and D48's: asking for them where conv_fwd_kernel
    runs (C = 32, or a misaligned input at C = 96) raises before any
    launch."""
    x, wt, mul, add, _ = _inputs(dev, 1, 32, 8, 64)
    with pytest.raises(ValueError):
        bc.conv3x3_fwd_cuda(x, wt, cycles=True)
    x, wt, mul, add, _ = _inputs(dev, 1, 96, 8, 64)
    with pytest.raises(ValueError):
        bc.conv3x3_fwd_cuda(_misaligned(x), wt, cycles=True)
