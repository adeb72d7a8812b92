"""D48, kernel D at channels that pad to 48 (``conv_d48_kernel``).

On the CPU: the x operand's addressing that the wrapper hands the kernel
(:func:`operand_plan` at Cp = 48), held to the im2col of every tap over an
operand packed here with numpy as the kernel's producer packs it (column
runs past W included); the int[11] the kernel takes; D96's plan values,
which D48's generalisation leaves as they were; the weight pack in its
[9, 6, 48, 8] layout as nine tap GEMMs; and the wrapper's plain version on
CPU tensors.  On a CUDA card (``cuda`` marker; skipped here): D48 against
the plain versions in all four modes (the dx conv, statistics, ``pre`` +
statistics, ``post``) at small shapes that reach every edge and at one
where the CTAs walk several tiles, bit-equal over two launches and to
``conv_fwd_kernel``, the routing of a misaligned input to
``conv_fwd_kernel``, and the stamps.  The machine with the card has no
JAX; run the card's tests without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_d48.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv as bc


def _bits(t: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> its uint16 codes."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _pack_operand(t: np.ndarray, c: int, oy0: int, ox0: int, plan: dict) -> np.ndarray:
    """The x operand of the tile at (oy0, ox0) of image t [C, H, W] (uint16
    bf16 codes of the transformed input), as the kernel's producers write
    it: channel group g, halo row r, column c at g * plane + r * row + c * 16
    bytes, 8 channels of one pixel; 0 outside the image and past C."""
    rows, cols = plan["halo"]
    buf = np.zeros(plan["channel_groups"] * plan["plane"] // 2, np.uint16)
    _, h, w = t.shape
    for g in range(plan["channel_groups"]):
        for r in range(rows):
            iy = oy0 - 1 + r
            if not 0 <= iy < h:
                continue
            lo, hi = max(0, 1 - ox0), min(cols, w + 1 - ox0)  # columns inside the image
            for e in range(8):
                if 8 * g + e >= c:
                    continue
                at = (g * plan["plane"] + r * plan["row"]) // 2 + e
                buf[at + lo * 8:at + hi * 8:8] = t[8 * g + e, iy, ox0 - 1 + lo:ox0 - 1 + hi]
    return buf


@pytest.mark.parametrize("c,w", [(48, 64), (48, 256), (48, 40), (40, 64), (40, 256), (40, 40)])
def test_d48_operand_addressing_is_im2col(c, w):
    """Every tile's x operand read through the wgmma descriptors the kernel
    builds from operand_plan(48) (start tap[kh*3 + kw] + rr * row + 2 * s *
    plane for tile row rr and k16 step s; then 8-pixel groups sbo apart, 16
    bytes a pixel, the two 8-channel halves lbo apart) is the im2col of that
    tap: A[m, k] = t[16 s + k, oy0 + rr + kh - 1, ox0 + m + kw - 1], 0 in the
    SAME padding and past C (C = 40: channels 40..47 of the last group).
    W = 40 ends in a column run partly past W (its outputs are masked; its
    operand is the zero padding); W = 256 has four runs."""
    plan = bc.operand_plan(48)
    assert plan["channel_groups"] == 6 and plan["w_lbo"] == 48 * 16
    assert plan["row"] % 32 == 16  # an odd pitch of 16-byte pixels
    assert plan["sbo"] == 128 and plan["lbo"] == plan["plane"]
    rows, cols = bc.D96_TILE
    for tap in plan["tap"]:
        assert tap + (rows - 1) * plan["row"] + cols * plan["pixel"] <= plan["plane"]
    g = torch.Generator().manual_seed(c + w)
    h = 8
    x = torch.randn(1, c, h, w, generator=g).to(torch.bfloat16)
    mul, add = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    t = bc.transform_input(x, mul, add)[0]
    codes = _bits(t)
    tp = np.zeros((48, h + 2, w + cols + 2), np.uint16)  # SAME padding, channels past C
    tp[:c, 1:h + 1, 1:w + 1] = codes
    m = np.arange(cols)[:, None]
    kk = np.arange(16)[None, :]
    for oy0 in range(0, h, rows):
        for ox0 in range(0, w, cols):
            buf = _pack_operand(codes, c, oy0, ox0, plan)
            for rr in range(rows):
                for tap, off in enumerate(plan["tap"]):
                    kh, kw = divmod(tap, 3)
                    for s in range(48 // 16):
                        start = off + rr * plan["row"] + 2 * s * plan["plane"]
                        byte = (start + (m // 8) * plan["sbo"] + (m % 8) * plan["pixel"]
                                + (kk // 8) * plan["lbo"] + (kk % 8) * 2)
                        a = buf[byte // 2]
                        want = tp[16 * s + kk, oy0 + rr + kh, ox0 + m + kw]
                        np.testing.assert_array_equal(a, want, err_msg=f"tile ({oy0}, {ox0}) "
                                                      f"row {rr} tap {tap} step {s}")


def test_d48_ops_are_the_plan():
    """The int[11] the wrapper hands the kernel (one for both widths) is
    operand_plan(48)'s plane, row and nine tap offsets: a plane holds one
    channel group at either width."""
    plan = bc.operand_plan(48)
    assert list(bc._d96_ops()) == [plan["plane"], plan["row"], *plan["tap"]]


def test_d96_plan_is_unchanged():
    """D96's operand plan keeps the values it had before D48 shared it, and
    operand_plan(48) differs from it only in the channel groups and the
    weights' K step."""
    want96 = {"pixel": 16, "row": 1072, "plane": 6432, "lbo": 6432, "sbo": 128,
              "tap": (0, 16, 32, 1072, 1088, 1104, 2144, 2160, 2176), "channel_groups": 12,
              "halo": (6, 66), "w_lbo": 1536}
    assert bc.d96_operand_plan() == want96 and bc.operand_plan(96) == want96
    assert bc.operand_plan(48) == {**want96, "channel_groups": 6, "w_lbo": 768}
    assert list(bc._d96_ops()) == [6432, 1072, *want96["tap"]]


def test_operand_plan_refuses_other_widths():
    """Only the two wgmma kernels' padded widths have a plan."""
    for cp in (32, 64, 128):
        with pytest.raises(ValueError):
            bc.operand_plan(cp)


@pytest.mark.parametrize("c,flip", [(48, False), (48, True), (40, False), (40, True)])
def test_d48_packed_weights_are_the_conv_as_tap_gemms(c, flip):
    """D48's packed weights [9, 6, 48, 8] (per tap, wgmma's B in core
    matrices of 8 C_out x 8 ci), read through the descriptor's strides
    (byte (ci // 8) * w_lbo + (co // 8) * sbo + (co % 8) * 16 + (ci % 8) * 2),
    as nine per-tap GEMMs over shifted inputs give the plain D (flipped: the
    dx conv) bit for bit in f64, and are 0 beyond C."""
    g = torch.Generator().manual_seed(10 * c + flip)
    x = torch.randn(1, c, 8, 16, generator=g).to(torch.bfloat16)
    w = torch.randn(c, c, 3, 3, generator=g) * 0.1
    wp = bc.pack_weights_plain(w, flip)
    assert wp.dtype == torch.bfloat16 and wp.shape == (9, 6, 48, 8)
    p = bc.operand_plan(48)
    co = torch.arange(48)[:, None]
    ci = torch.arange(48)[None, :]
    byte = (ci // 8) * p["w_lbo"] + (co // 8) * p["sbo"] + (co % 8) * 16 + (ci % 8) * 2
    mats = torch.stack([wp[tap].reshape(-1)[byte // 2] for tap in range(9)])
    assert torch.equal(mats.reshape(-1).sort().values, wp.reshape(-1).sort().values)
    assert not mats[:, c:].any() and not mats[:, :, c:].any()
    xp = torch.nn.functional.pad(x.double(), (1, 1, 1, 1))
    acc = torch.zeros(c, 8, 16, dtype=torch.float64)
    for tap in range(9):
        kh, kw = divmod(tap, 3)
        acc += torch.einsum("oi,ihw->ohw", mats[tap, :c, :c].double(),
                            xp[0, :, kh:kh + 8, kw:kw + 16])
    want = torch.nn.functional.conv2d(x.double(), (bc.flip_weight(w) if flip else w)
                                      .to(torch.bfloat16).double(), padding=1)[0]
    torch.testing.assert_close(acc, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("c", [48, 40])
def test_d48_on_cpu_takes_the_plain_version(c):
    """A CPU tensor never reaches a kernel: conv3x3_fwd and conv3x3_dx_post
    at a width that pads to 48 are their plain versions, and no counter
    moves."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(1, c, 8, 64, generator=g).to(torch.bfloat16)
    dy = torch.randn(1, c, 8, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(c, c, 3, 3, generator=g) * 0.05
    mul, add = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    assert bc.fwd_kernel(x.shape, (256, 512)) == 48
    f = bc.conv3x3_fwd_cuda
    before = (f.launches, f.launches_c48, f.launches_c48_post)
    y, s = bc.conv3x3_fwd(x, w, mul, add)
    yp, sp = bc.conv3x3_fwd_plain(x, w, mul, add)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    dt, none = bc.conv3x3_fwd(dy, w, stats=False, flip=True)
    assert none is None and torch.equal(dt, bc.conv3x3_fwd_plain(dy, w, stats=False, flip=True)[0])
    dx, ds = bc.conv3x3_dx_post(dy, w, x, mul, add)
    dxp, dsp = bc.conv3x3_dx_post_plain(dy, w, x, mul, add)
    assert torch.equal(dx, dxp) and torch.equal(ds, dsp)
    assert (f.launches, f.launches_c48, f.launches_c48_post) == before


def test_d48_stamps_are_named():
    """D48's stamps: 13 per CTA, clock64 phases first (the consumer's tile
    loop after the five it holds), then the four global-timer marks."""
    names = bc.D48_PHASES
    assert len(names) == 13 and len(set(names)) == 13
    assert names.index("consumer: tile loop") == 8
    assert all("global" in k for k in names[9:]) and not any("global" in k for k in names[:9])


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
# past W), 128 (two runs); C = 40 (channels and C_out past C by position);
# H = 8 and 16 (halos at the top and bottom, 2 and 4 tile rows); and
# [4,48,128,256]: 512 tiles, 3 or 4 a CTA, so each CTA's tiles go through
# both x buffers and both accumulator sets, ending on either
D48_SHAPES = [(1, 48, 8, 64), (2, 48, 8, 96), (1, 48, 16, 128), (2, 40, 8, 40), (1, 40, 8, 96),
              (4, 48, 128, 256)]


def _modes(x, wt, mul, add, dy):
    """mode -> a call of the dispatching wrapper on those inputs."""
    return {"dx": lambda: bc.conv3x3_fwd(dy, wt, stats=False, flip=True),
            "stats": lambda: bc.conv3x3_fwd(x, wt),
            "pre+stats": lambda: bc.conv3x3_fwd(x, wt, mul, add),
            "post": lambda: bc.conv3x3_dx_post(dy, wt, x, mul, add)}


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", D48_SHAPES)
@pytest.mark.parametrize("mode", ["dx", "stats", "pre+stats", "post"])
def test_d48_matches_plain(dev, n, c, h, w, mode):
    """D48 in each mode against the plain version: y (dx, dt) within one
    bf16 ulp, the statistics within 1e-3 of each row's max; post's dx within
    one ulp of dt through the scale plus its own rounding (2^-6 relative)
    and bit-equal to D48's own dx conv followed by pre_backward.  Counted in
    launches_c48 (post also in launches_c48_post), two launches bit-equal."""
    x, wt, mul, add, dy = _inputs(dev, n, c, h, w)
    f = bc.conv3x3_fwd_cuda
    before = (f.launches_c48, f.launches_c48_post, f.launches_c96)
    call = _modes(x, wt, mul, add, dy)[mode]
    out = [call() for _ in range(2)]
    torch.cuda.synchronize()
    assert (f.launches_c48 - before[0], f.launches_c48_post - before[1],
            f.launches_c96 - before[2]) == (2, 2 * (mode == "post"), 0)
    if mode == "post":
        dt = bc.conv3x3_fwd(dy, wt, stats=False, flip=True)[0]
        assert torch.equal(out[0][0], bc.pre_backward(x, dt, mul, add)[0])
        want, sp = bc.conv3x3_dx_post_plain(dy, wt, x, mul, add)
        err = (out[0][0].float() - want.float()).abs()
        assert bool((err <= 2.0 ** -6 * want.float().abs() + 1e-4).all()), err.max().item()
    else:
        pre = (mul, add) if mode == "pre+stats" else ()
        src = dy if mode == "dx" else x
        want, sp = bc.conv3x3_fwd_plain(src, wt, *pre, stats=mode != "dx", flip=mode == "dx")
        assert _within_one_ulp(out[0][0], want), (out[0][0].float() - want.float()).abs().max()
    assert torch.equal(out[0][0], out[1][0])
    assert (out[0][1] is None) == (sp is None)
    if sp is not None:
        assert torch.equal(out[0][1], out[1][1]) and _stats_ok(out[0][1], sp)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", [(2, 48, 8, 96), (2, 40, 8, 40), (4, 48, 128, 256)])
def test_d48_is_bit_equal_to_conv_fwd_kernel_in_every_mode(dev, n, c, h, w):
    """Misaligned copies of the inputs take conv_fwd_kernel (D's counter
    moves, D48's does not); D48 keeps its k order (tap-major, ci ascending,
    one f32 sum per k16 step), so y, the dx conv and post's dx are bit-equal
    to it, and the [2,C] sums agree within f32 reordering (1e-3 of each
    row's max)."""
    x, wt, mul, add, dy = _inputs(dev, n, c, h, w, seed=1)
    xm, dym = _misaligned(x), _misaligned(dy)
    f = bc.conv3x3_fwd_cuda
    mine = _modes(x, wt, mul, add, dy)
    old = _modes(xm, wt, mul, add, dym)
    for mode in mine:
        a = mine[mode]()
        before = (f.launches, f.launches_c48, f.launches_c96)
        b = old[mode]()
        torch.cuda.synchronize()
        assert (f.launches - before[0], f.launches_c48 - before[1],
                f.launches_c96 - before[2]) == (1, 0, 0), mode
        assert torch.equal(a[0], b[0]), (mode, (a[0].float() - b[0].float()).abs().max().item())
        if a[1] is not None:
            assert _stats_ok(a[1], b[1]), mode


@pytest.mark.cuda
@pytest.mark.parametrize("post", [False, True])
def test_d48_stamps(dev, post):
    """D48's stamps: one row per CTA (as many as tiles here), every tile
    loop and x fill non-empty, the loop no shorter than its consumer's
    phases, the global timer's marks in order (start, loop start, loop end,
    end), and the launch's output the same bits as a launch without
    stamps."""
    x, wt, mul, add, dy = _inputs(dev, 2, 48, 8, 96, seed=3)
    if post:
        dx, s, cyc = bc.conv3x3_dx_post_cuda(dy, wt, x, mul, add, cycles=True)
        want = bc.conv3x3_dx_post(dy, wt, x, mul, add)
    else:
        dx, s, cyc = bc.conv3x3_fwd_cuda(x, wt, mul, add, cycles=True)
        want = bc.conv3x3_fwd(x, wt, mul, add)
    torch.cuda.synchronize()
    assert cyc.shape == (2 * 2 * 2, len(bc.D48_PHASES))
    assert bool((cyc[:, 8] > 0).all()) and bool((cyc[:, 2] > 0).all())
    assert bool((cyc[:, :9] >= 0).all())
    assert bool((cyc[:, 3:8].sum(dim=1) <= cyc[:, 8]).all())
    assert bool((cyc[:, 10:13] >= cyc[:, 9:12]).all())
    assert torch.equal(dx, want[0]) and torch.equal(s, want[1])


@pytest.mark.cuda
def test_d48_refuses_stamps_elsewhere(dev):
    """Stamps are D96's and D48's: asking for them where conv_fwd_kernel
    runs (C = 32, or a misaligned input at C = 48) raises before any
    launch."""
    x, wt, _, _, _ = _inputs(dev, 1, 32, 8, 64)
    with pytest.raises(ValueError):
        bc.conv3x3_fwd_cuda(x, wt, cycles=True)
    x, wt, _, _, _ = _inputs(dev, 1, 48, 8, 64)
    f = bc.conv3x3_fwd_cuda
    before = f.launches
    with pytest.raises(ValueError):
        bc.conv3x3_fwd_cuda(_misaligned(x), wt, cycles=True)
    assert f.launches == before


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("overrides,want", [
    # config 5 as shipped (crop 1024, modules 1, 4, 3, remat stages:3): 128
    # fused convs a forward on branches 0 (D48) and 1 (D96); teacher,
    # student, stage 3's re-run (64) and the dx convs, 64 of them in post
    ({}, (448, 64, 224, 32, 224, 32)),
    # one module a stage (the ddp and spatial phases' depth): 48 convs a
    # forward, stage 3's re-run 16
    ({"model.hrnet_modules": [1, 1, 1]}, (160, 24, 80, 12, 80, 12)),
    # no remat: no re-run
    ({"model.remat": "none"}, (384, 64, 192, 32, 192, 32)),
    # a width-8 HRNet at crop 512: branches 0-2 eligible (sides 128, 64, 32),
    # none pads to 48 or 96, so every launch is conv_fwd_kernel's
    ({"model.hrnet_width": 8, "model.hrnet_modules": [1, 1, 1], "data.crop_size": 512},
     (216, 32, 0, 0, 0, 0)),
])
def test_chip_smoke_derives_d_launches_from_the_model(overrides, want):
    """chip_smoke.py holds config 5's step to D's launches per kernel and
    mode, counted from the model's modules, blocks, branch shapes and remat
    plan."""
    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config

    cs = _chip_smoke()
    cfg = load_config(cs.CONFIG5, {"data.dataset": "synthetic", **overrides})
    keys = ("branch_conv_fwd", "branch_conv_dx_post", "branch_conv_fwd_c96",
            "branch_conv_dx_post_c96", "branch_conv_fwd_c48", "branch_conv_dx_post_c48")
    assert cs.d_launches(cfg, bc) == dict(zip(keys, want))
