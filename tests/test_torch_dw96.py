"""E96, kernel E at channels that pad to 96 (``conv_dw96_kernel``).

On the CPU: the choice of E96 before the launch (:func:`dw_c96`, a pure
function of the shape and the addresses), the wrapper's refusal of what
E96 does not take, and the count of E's launches per config-5 step that
``chip_smoke.py`` derives from the model.  On a CUDA card (``cuda``
marker; skipped here): E96 against the plain version in every mode, at
small shapes that reach every edge, bit-equal over two launches, and the
routing of what it does not take to ``conv_dw_kernel``.  The machine with
the card has no JAX; run the card's tests without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dw96.py
"""

import os
import sys

import pytest
import torch

from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv as bc

A = 1 << 20  # a 16-byte aligned address


# (x's shape [N,C,H,W], the addresses of x, dy (and y, dY with fuse), E96?)
CHOICES = {
    "config 5 branch 1, fuse": ((8, 96, 128, 128), (A, 2 * A, 3 * A, 4 * A), True),
    "config 5 branch 1, no fuse": ((8, 96, 128, 128), (A, 2 * A), True),
    "C = 88 pads to 96": ((2, 88, 32, 72), (A, 2 * A, 3 * A, 4 * A), True),
    "C = 81 pads to 96": ((1, 81, 32, 40), (A, 2 * A), True),
    "C = 80 pads to 80": ((1, 80, 32, 40), (A, 2 * A), False),
    "C = 48 (branch 0)": ((8, 48, 256, 256), (A, 2 * A, 3 * A, 4 * A), False),
    "C = 128": ((1, 128, 32, 32), (A, 2 * A), False),
    "W % 8 != 0": ((1, 96, 64, 33), (A, 2 * A), False),
    "ragged last column tile, W = 72": ((1, 96, 32, 72), (A, 2 * A, 3 * A, 4 * A), True),
    "x 2 bytes past a 16-byte boundary": ((8, 96, 128, 128), (A + 2, 2 * A, 3 * A, 4 * A), False),
    "x 8 bytes past a 16-byte boundary": ((8, 96, 128, 128), (A + 8, 2 * A), False),
    "y 2 bytes past a 16-byte boundary": ((8, 96, 128, 128), (A, 2 * A, 3 * A + 2, 4 * A), False),
    "y 8 bytes past a 16-byte boundary": ((8, 96, 128, 128), (A, 2 * A, 3 * A + 8, 4 * A), False),
    "dY 8 bytes past a 16-byte boundary": ((8, 96, 128, 128), (A, 2 * A, 3 * A, 4 * A + 8), False),
}


@pytest.mark.parametrize("case", sorted(CHOICES))
def test_dw96_kernel_choice(case):
    """E96 exactly where the channels pad to 96, W % 8 == 0 and every
    pointer handed over is 16-byte aligned (also TMA's conditions); with no
    fuse, y and dY are not among the pointers and cannot refuse it."""
    shape, ptrs, want = CHOICES[case]
    assert bc.dw_c96(shape, ptrs) is want
    # the ring's conditions are E96's but for the width
    assert bc.dw_async(shape, ptrs) is (shape[3] % 8 == 0 and all(p % 16 == 0 for p in ptrs))
    if want:
        assert bc.fwd_c96(shape, ptrs) and not bc.fwd_c48(shape, ptrs)


def test_dw_launch_refuses_cpu_tensors_and_unknown_kernels():
    """The launcher takes CUDA tensors only, and no kernel but E's three."""
    x = torch.zeros(1, 96, 32, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        bc.conv3x3_dw_launch(x, x.clone(), kernel="e96")
    with pytest.raises(ValueError):
        bc.conv3x3_dw_cuda(x, x.clone())


def test_dw_on_cpu_takes_the_plain_version():
    """A CPU tensor never reaches a kernel: conv3x3_dw is conv3x3_dw_plain,
    and no counter moves."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 88, 32, 40, generator=g).to(torch.bfloat16)
    dy = (torch.randn(1, 88, 32, 40, generator=g) * 1e-2).to(torch.bfloat16)
    y = torch.randn(1, 88, 32, 40, generator=g).to(torch.bfloat16)
    ds = torch.randn(2, 88, generator=g) * 1e-3
    f = bc.conv3x3_dw_cuda
    before = (f.launches, f.launches_c96, f.launches_async)
    dk, dY = bc.conv3x3_dw(x, dy, y, ds)
    dkp, dYp = bc.conv3x3_dw_plain(x, dy, y, ds)
    assert torch.equal(dk, dkp) and torch.equal(dY, dYp)
    assert (f.launches, f.launches_c96, f.launches_async) == before


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("overrides,want", [
    # config 5 as shipped (crop 1024): branch 0 (48 ch at 256^2) and branch 1
    # (96 ch at 128^2) in all 8 modules, 4 blocks of 2 convs each
    ({}, {"branch_conv_dw": 128, "branch_conv_dw_async": 0, "branch_conv_dw_c96": 64,
          "branch_conv_dw_c48": 64}),
    # crop 512: branch 1 at 64^2 is still eligible (H % 32 == 0)
    ({"data.crop_size": 512},
     {"branch_conv_dw": 128, "branch_conv_dw_async": 0, "branch_conv_dw_c96": 64,
      "branch_conv_dw_c48": 64}),
    # a width-8 HRNet at crop 512: no branch pads to 96 or 48; branches 0-2
    # (sides 128, 64, 32) eligible, branch 3 (16) not: 2 + 3 + 3 branches x
    # 8 convs, all on the ring
    ({"model.hrnet_width": 8, "model.hrnet_modules": [1, 1, 1], "data.crop_size": 512},
     {"branch_conv_dw": 64, "branch_conv_dw_async": 64, "branch_conv_dw_c96": 0,
      "branch_conv_dw_c48": 0}),
])
def test_chip_smoke_derives_e_launches_from_the_model(overrides, want):
    """chip_smoke.py holds config 5's step to E's launches per kernel,
    counted from the model's modules, blocks and branch shapes: at C = 96
    on E96, at C = 48 on E48, none on conv_dw_kernel's ring."""
    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config

    cs = _chip_smoke()
    cfg = load_config(cs.CONFIG5, {"data.dataset": "synthetic", **overrides})
    assert cs.e_launches(cfg, bc) == want


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
    ds = torch.randn(2, c, generator=g, device=dev) * 1e-3
    y = bc.conv3x3_fwd(x, wt, mul, add)[0]
    return x, mul, add, dy, ds, y


def _modes(mul, add, ds, y):
    return {"plain": (), "pre": (None, None, mul, add), "fuse": (y, ds),
            "fuse+pre": (y, ds, mul, add)}


def _misaligned(t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


# every edge: one image and two, a 32-pixel column tile that is whole (W =
# 32), ragged (W = 40: 8 of a second tile; W = 72: 8 of a third), x boxes
# past the image on every side, C = 88 (8 channels of the last CTA's rows
# and of every x box past C)
@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", [(1, 96, 32, 32), (2, 96, 32, 40), (1, 96, 32, 72),
                                     (2, 88, 32, 72), (1, 88, 32, 40)])
@pytest.mark.parametrize("mode", ["plain", "pre", "fuse", "fuse+pre"])
def test_e96_matches_plain(dev, n, c, h, w, mode):
    """dY bit-equal to the plain version's (the same f32 roundings), dk
    within 1e-3 of max|dk| (f32 sums over the pixels in another order), on
    E96 (counted), and two launches bit-equal (fixed-order partials)."""
    x, mul, add, dy, ds, y = _inputs(dev, n, c, h, w)
    args = _modes(mul, add, ds, y)[mode]
    f = bc.conv3x3_dw_cuda
    before = (f.launches_c96, f.launches_async)
    dk, dY = bc.conv3x3_dw(x, dy, *args)
    dk2, dY2 = bc.conv3x3_dw(x, dy, *args)
    torch.cuda.synchronize()
    assert (f.launches_c96 - before[0], f.launches_async - before[1]) == (2, 0)
    dkp, dYp = bc.conv3x3_dw_plain(x, dy, *args)
    assert (dY is None) == (dYp is None)
    if dY is not None:
        assert torch.equal(dY, dYp), (dY.float() - dYp.float()).abs().max().item()
    assert (dk - dkp).abs().max().item() <= 1e-3 * dkp.abs().max().item()
    assert torch.equal(dk, dk2) and (dY is None or torch.equal(dY, dY2))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "y"])
def test_e96_misaligned_input_takes_conv_dw_kernel(dev, which):
    """x or y 2 bytes past a 16-byte boundary: conv_dw_kernel's
    synchronous fill (neither E96's counter nor the ring's moves), dY
    bit-equal to E96's and dk within 1e-3 of E96's."""
    x, mul, add, dy, ds, y = _inputs(dev, 2, 96, 32, 72, seed=1)
    dk, dY = bc.conv3x3_dw(x, dy, y, ds, mul, add)
    xm, ym = (_misaligned(x), y) if which == "x" else (x, _misaligned(y))
    f = bc.conv3x3_dw_cuda
    before = (f.launches, f.launches_c96, f.launches_async)
    dko, dYo = bc.conv3x3_dw(xm, dy, ym, ds, mul, add)
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.launches_c96 - before[1],
            f.launches_async - before[2]) == (1, 0, 0)
    assert torch.equal(dYo, dY)
    assert (dko - dk).abs().max().item() <= 1e-3 * dk.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", [(1, 96, 32, 33), (1, 80, 32, 40), (2, 48, 32, 72),
                                     (1, 112, 32, 32)])
def test_outside_e96_never_reaches_it(dev, n, c, h, w):
    """A CUDA tensor outside E96's conditions (W % 8 != 0, channels that pad
    to another width) runs on conv_dw_kernel, and naming E96 for it raises."""
    x, mul, add, dy, ds, y = _inputs(dev, n, c, h, w, seed=2)
    f = bc.conv3x3_dw_cuda
    before = f.launches_c96
    dk, dY = bc.conv3x3_dw(x, dy, y, ds, mul, add)
    torch.cuda.synchronize()
    assert f.launches_c96 == before
    dkp, dYp = bc.conv3x3_dw_plain(x, dy, y, ds, mul, add)
    assert torch.equal(dY, dYp)
    assert (dk - dkp).abs().max().item() <= 1e-3 * dkp.abs().max().item()
    with pytest.raises(ValueError):
        bc.conv3x3_dw_launch(x, dy, y, ds, mul, add, kernel="e96")
    assert f.launches_c96 == before


@pytest.mark.cuda
def test_e96_phase_cycles(dev):
    """E96's stamps: one row per CTA; every CTA's tile loop non-empty and
    no shorter than thread 0's phases inside it; its global-timer stamps
    in order (start, loop start, loop end, partial stored, end)."""
    x, mul, add, dy, ds, y = _inputs(dev, 2, 96, 32, 72, seed=3)
    dk, dY, cyc = bc.conv3x3_dw_launch(x, dy, y, ds, mul, add, kernel="e96", cycles=True)
    torch.cuda.synchronize()
    assert cyc.shape[1] == len(bc.DW96_PHASES) == 11 and cyc.shape[0] % 3 == 0
    assert bool((cyc[:, 4] > 0).all()) and bool((cyc[:, :6] >= 0).all())
    assert bool((cyc[:, :4].sum(dim=1) <= cyc[:, 4]).all())
    assert bool((cyc[:, 7:11] >= cyc[:, 6:10]).all())
    assert torch.equal(dk, bc.conv3x3_dw(x, dy, y, ds, mul, add)[0])
