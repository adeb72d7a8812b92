"""E48, kernel E at channels that pad to 48 (``conv_dw48_kernel``).

On the CPU: the choice of E48 before the launch (:func:`dw_c48`, a pure
function of the shape and the addresses); E48's operand addressing
(:func:`dw48_operand_plan`), held to the plain weight gradient by reading a
dY stage and an x operand, packed here with numpy as TMA and the kernel's
producers lay them out, through the descriptors' offsets, strides and
128-byte swizzle, tile by tile, as nine tap GEMMs; the launcher's refusals;
the stamps' names; and the wrapper's plain version on CPU tensors.  On a
CUDA card (``cuda`` marker; skipped here): E48 against the plain version in
all four modes at small shapes that reach every edge and at one where the
CTAs walk several tiles, bit-equal over two launches, dY bit-equal to
``conv_dw_kernel``'s ring, what E48 does not take routed to
``conv_dw_kernel``, and the stamps.  The machine with the card has no JAX;
run the card's tests without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dw48.py
"""

import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv as bc

A = 1 << 20  # a 16-byte aligned address


# (x's shape [N,C,H,W], the addresses of x, dy (and y, dY with fuse), E48?)
CHOICES = {
    "config 5 branch 0, fuse": ((8, 48, 256, 256), (A, 2 * A, 3 * A, 4 * A), True),
    "config 5 branch 0, no fuse": ((8, 48, 256, 256), (A, 2 * A), True),
    "C = 40 pads to 48": ((2, 40, 32, 72), (A, 2 * A, 3 * A, 4 * A), True),
    "C = 33 pads to 48": ((1, 33, 32, 64), (A, 2 * A), True),
    "C = 32 pads to 32": ((1, 32, 32, 64), (A, 2 * A), False),
    "C = 96 (branch 1)": ((8, 96, 128, 128), (A, 2 * A, 3 * A, 4 * A), False),
    "W % 8 != 0": ((1, 48, 32, 70), (A, 2 * A), False),
    "ragged last column tile, W = 72": ((1, 48, 32, 72), (A, 2 * A, 3 * A, 4 * A), True),
    "x 2 bytes past a 16-byte boundary": ((8, 48, 256, 256), (A + 2, 2 * A, 3 * A, 4 * A), False),
    "x 8 bytes past a 16-byte boundary": ((8, 48, 256, 256), (A + 8, 2 * A), False),
    "dy 2 bytes past a 16-byte boundary": ((8, 48, 256, 256), (A, 2 * A + 2), False),
    "dy 8 bytes past a 16-byte boundary": ((8, 48, 256, 256), (A, 2 * A + 8, 3 * A, 4 * A), False),
    "y 2 bytes past a 16-byte boundary": ((8, 48, 256, 256), (A, 2 * A, 3 * A + 2, 4 * A), False),
    "y 8 bytes past a 16-byte boundary": ((8, 48, 256, 256), (A, 2 * A, 3 * A + 8, 4 * A), False),
    "dY 2 bytes past a 16-byte boundary": ((8, 48, 256, 256), (A, 2 * A, 3 * A, 4 * A + 2), False),
    "dY 8 bytes past a 16-byte boundary": ((8, 48, 256, 256), (A, 2 * A, 3 * A, 4 * A + 8), False),
}


@pytest.mark.parametrize("case", sorted(CHOICES))
def test_dw48_kernel_choice(case):
    """E48 exactly where the channels pad to 48, W % 8 == 0 and every
    pointer handed over is 16-byte aligned (also TMA's conditions); the
    kernel dw_kernel names is E48 there, never E96, and elsewhere E96, the
    ring or the fill as before."""
    shape, ptrs, want = CHOICES[case]
    assert bc.dw_c48(shape, ptrs) is want
    assert not (bc.dw_c48(shape, ptrs) and bc.dw_c96(shape, ptrs))
    ring = shape[3] % 8 == 0 and all(p % 16 == 0 for p in ptrs)
    other = "e96" if bc.dw_c96(shape, ptrs) else "ring" if ring else "fill"
    assert bc.dw_kernel(shape, ptrs) == ("e48" if want else other)


def _bits(t: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> its uint16 codes."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _values(codes: np.ndarray) -> np.ndarray:
    """uint16 bf16 codes -> float64 values."""
    return (codes.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _x_operand(t: np.ndarray, c: int, oy0: int, ox0: int, plan: dict) -> np.ndarray:
    """The x operand of the tile at (oy0, ox0) of the transformed image t
    [C, H, W] (uint16 codes), as E48's producers write it (D48's layout):
    channel group g, halo row r, column q at g * plane + r * row + q * 16
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
            for e in range(min(8, c - 8 * g)):
                at = (g * plan["plane"] + r * plan["row"]) // 2 + e
                buf[at + lo * 8:at + hi * 8:8] = t[8 * g + e, iy, ox0 - 1 + lo:ox0 - 1 + hi]
    return buf


def _dy_stage(dY: np.ndarray, c: int, oy0: int, ox0: int, p: dict) -> np.ndarray:
    """A tile's dY stage (uint16 codes) as TMA's 128-byte swizzle lands the
    four row boxes and the compose leaves them: output row rr's box at rr *
    a_row_box, C_out co's line at co * a_line, pixel px in chunk (px // 8) ^
    (co % 8) of the line; 0 past W and past C."""
    rows, cols = p["tile"]
    buf = np.zeros(rows * p["a_row_box"] // 2, np.uint16)
    _, h, w = dY.shape
    for rr in range(rows):
        for co in range(c):
            for px in range(min(cols, w - ox0)):
                q = (px // 8) ^ (co % 8)
                at = rr * p["a_row_box"] + co * p["a_line"] + q * 16 + (px % 8) * 2
                buf[at // 2] = dY[co, oy0 + rr, ox0 + px]
    return buf


def _read_a(stage: np.ndarray, rr: int, s: int, p: dict) -> np.ndarray:
    """A [64 C_out, 16 pixels] of k16 step s of output row rr, as the
    consumers' ldmatrix reads it into registers: C_out m's line, pixels
    16 s + k in chunk (2 s + k // 8) ^ (m % 8) of it; rows 48-63 zero."""
    m = np.arange(48)[:, None]
    k = np.arange(16)[None, :]
    byte = (rr * p["a_row_box"] + m * p["a_line"] + (((2 * s + k // 8) ^ (m % 8)) * 16)
            + (k % 8) * 2)
    return np.concatenate([stage[byte // 2], np.zeros((p["a_rows"] - 48, 16), np.uint16)])


def _read_b(xop: np.ndarray, tap: int, rr: int, s: int, p: dict) -> np.ndarray:
    """B [16 pixels, 48 ci] of tap ``tap``, output row rr, k16 step s, read
    as the MN-major descriptor without swizzle reads it: core matrices of 8
    pixels (16 bytes apart) x 8 ci (contiguous), K groups b_lbo apart, N
    groups b_sbo apart, from the tap's start offset."""
    k = np.arange(16)[:, None]
    n = np.arange(48)[None, :]
    start = p["tap"][tap] + rr * p["row"] + s * p["b_kstep"]
    byte = start + (k // 8) * p["b_lbo"] + (k % 8) * 16 + (n // 8) * p["b_sbo"] + (n % 8) * 2
    return xop[byte // 2]


@pytest.mark.parametrize("c,w", [(48, 72), (40, 72), (48, 64)])
def test_dw48_operand_addressing_is_the_weight_gradient(c, w):
    """Every tile's dY stage and x operand, read as the products read them
    (dw48_operand_plan: A = dY by ldmatrix through the 128-byte swizzle, M =
    64 of which rows 48-63 are zero; B = the x operand by an MN-major
    descriptor at each tap's start offset), summed over the 16 k16 steps of
    every tile as
    nine tap GEMMs, is conv3x3_dw_plain's dk (fuse + pre): within f32
    reordering of its f32 sum, and exact against the f64 weight gradient.
    W = 72 ends in a column tile of 8 pixels (dY past W is 0); C = 40 leaves
    channels 40..47 of dY and of the x operand 0."""
    p = bc.dw48_operand_plan()
    xplan = bc.operand_plan(48)
    rows, cols = p["tile"]
    assert p["a_row_box"] == 48 * p["a_line"] and p["a_line"] == p["a_swizzle"]
    assert p["b_sbo"] == xplan["plane"] and p["row"] == xplan["row"] and p["tap"] == xplan["tap"]
    assert p["k_steps"] == rows * cols // 16 and 0 < p["taps_wg0"] < 9
    g = torch.Generator().manual_seed(c + w)
    h = 8
    x = torch.randn(1, c, h, w, generator=g).to(torch.bfloat16)
    dy = (torch.randn(1, c, h, w, generator=g) * 1e-2).to(torch.bfloat16)
    y = torch.randn(1, c, h, w, generator=g).to(torch.bfloat16)
    ds = torch.randn(2, c, generator=g) * 1e-3
    mul, add = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    dkp, dYp = bc.conv3x3_dw_plain(x, dy, y, ds, mul, add)
    t = bc.transform_input(x, mul, add)
    tcodes, dYcodes = _bits(t[0]), _bits(dYp[0])
    acc = np.zeros((9, 48, 48))
    for oy0 in range(0, h, rows):
        for ox0 in range(0, w, cols):
            xop = _x_operand(tcodes, c, oy0, ox0, xplan)
            stage = _dy_stage(dYcodes, c, oy0, ox0, p)
            for ks in range(p["k_steps"]):
                rr, s = divmod(ks, 4)
                a = _values(_read_a(stage, rr, s, p))[:48]  # rows 48-63 are zero
                for tap in range(9):
                    acc[tap] += a @ _values(_read_b(xop, tap, rr, s, p))
    dk = torch.from_numpy(acc[:, :c, :c]).permute(1, 2, 0).reshape(c, c, 3, 3)
    assert not acc[:, c:].any() and not acc[:, :, c:].any()
    want64 = torch.nn.grad.conv2d_weight(t.double(), (c, c, 3, 3), dYp.double(), padding=1)
    torch.testing.assert_close(dk, want64, rtol=1e-12, atol=1e-12)
    assert (dk - dkp.double()).abs().max().item() <= 1e-5 * dkp.abs().max().item()


@pytest.mark.parametrize("kernel,cycles,device,match", [
    ("e48", False, "cpu", "CUDA"),           # a CPU tensor reaches no kernel
    ("e64", False, "cpu", "unknown E kernel"),
    ("ring", True, "cpu", "stamps are E96's and E48's"),
])
def test_dw_launch_refusals(kernel, cycles, device, match):
    """The launcher takes CUDA tensors only, no kernel but E's four, and
    stamps only from E96 and E48; each refusal is checked before anything
    is launched."""
    x = torch.zeros(1, 48, 32, 64, dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match=match):
        bc.conv3x3_dw_launch(x, x.clone(), kernel=kernel, cycles=cycles)


@pytest.mark.parametrize("c", [48, 40])
def test_dw48_on_cpu_takes_the_plain_version(c):
    """A CPU tensor never reaches a kernel: conv3x3_dw at a width that pads
    to 48 is conv3x3_dw_plain, and no counter moves."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(1, c, 32, 64, generator=g).to(torch.bfloat16)
    dy = (torch.randn(1, c, 32, 64, generator=g) * 1e-2).to(torch.bfloat16)
    y = torch.randn(1, c, 32, 64, generator=g).to(torch.bfloat16)
    ds = torch.randn(2, c, generator=g) * 1e-3
    mul, add = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    assert bc.dw_kernel(x.shape, (256, 512, 768)) == "e48"
    f = bc.conv3x3_dw_cuda
    before = (f.launches, f.launches_c48, f.launches_async)
    dk, dY = bc.conv3x3_dw(x, dy, y, ds, mul, add)
    dkp, dYp = bc.conv3x3_dw_plain(x, dy, y, ds, mul, add)
    assert torch.equal(dk, dkp) and torch.equal(dY, dYp)
    assert (f.launches, f.launches_c48, f.launches_async) == before


def test_dw48_stamps_are_named():
    """E48's stamps: 16 per CTA, clock64 phases first (the consumer's tile
    loop after the eleven it follows), then the four global-timer marks."""
    names = bc.DW48_PHASES
    assert len(names) == 16 and len(set(names)) == 16
    assert names.index("consumer: tile loop") == 11
    assert all("global" in k for k in names[12:]) and not any("global" in k for k in names[:12])


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


# every edge: one image and two, a 64-pixel column tile that is whole (W =
# 64), ragged (W = 72: 8 of a second; W = 40: one tile of 40), x boxes and
# halo columns past the image on every side, C = 40 and 33 (channels of dY
# and x past C), and [8,48,128,128], where each CTA walks ~4 tiles through
# both stages and both barrier phases
@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", [(1, 48, 32, 64), (2, 48, 32, 72), (1, 40, 32, 40),
                                     (2, 33, 32, 128), (8, 48, 128, 128)])
@pytest.mark.parametrize("mode", ["plain", "pre", "fuse", "fuse+pre"])
def test_e48_matches_plain(dev, n, c, h, w, mode):
    """dY bit-equal to the plain version's (the same f32 roundings), dk
    within 1e-3 of max|dk| (f32 sums over the pixels in another order), on
    E48 (counted), and two launches bit-equal (fixed-order partials)."""
    x, mul, add, dy, ds, y = _inputs(dev, n, c, h, w)
    args = _modes(mul, add, ds, y)[mode]
    f = bc.conv3x3_dw_cuda
    before = (f.launches_c48, f.launches_async, f.launches_c96)
    dk, dY = bc.conv3x3_dw(x, dy, *args)
    dk2, dY2 = bc.conv3x3_dw(x, dy, *args)
    torch.cuda.synchronize()
    assert (f.launches_c48 - before[0], f.launches_async - before[1],
            f.launches_c96 - before[2]) == (2, 0, 0)
    dkp, dYp = bc.conv3x3_dw_plain(x, dy, *args)
    assert (dY is None) == (dYp is None)
    if dY is not None:
        assert torch.equal(dY, dYp), (dY.float() - dYp.float()).abs().max().item()
    assert (dk - dkp).abs().max().item() <= 1e-3 * dkp.abs().max().item()
    assert torch.equal(dk, dk2) and (dY is None or torch.equal(dY, dY2))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fuse", "fuse+pre"])
def test_e48_matches_the_ring(dev, mode):
    """E48 against conv_dw_kernel's ring, named to the launcher, on the same
    aligned inputs: dY bit-equal, dk within 1e-3 of max|dk|."""
    x, mul, add, dy, ds, y = _inputs(dev, 2, 48, 64, 136, seed=4)
    args = _modes(mul, add, ds, y)[mode]
    dk, dY, _ = bc.conv3x3_dw_launch(x, dy, *args, kernel="e48")
    dkr, dYr, _ = bc.conv3x3_dw_launch(x, dy, *args, kernel="ring")
    torch.cuda.synchronize()
    assert torch.equal(dY, dYr)
    assert (dk - dkr).abs().max().item() <= 1e-3 * dkr.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "dy", "y"])
def test_e48_misaligned_input_takes_conv_dw_kernel(dev, which):
    """x, dy or y 2 bytes past a 16-byte boundary: conv_dw_kernel's
    synchronous fill (neither E48's counter nor the ring's moves), dY
    bit-equal to E48's and dk within 1e-3 of E48's."""
    x, mul, add, dy, ds, y = _inputs(dev, 2, 48, 32, 72, seed=1)
    dk, dY = bc.conv3x3_dw(x, dy, y, ds, mul, add)
    args = {"x": x, "dy": dy, "y": y}
    args[which] = _misaligned(args[which])
    f = bc.conv3x3_dw_cuda
    before = (f.launches, f.launches_c48, f.launches_async)
    dko, dYo = bc.conv3x3_dw(args["x"], args["dy"], args["y"], ds, mul, add)
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.launches_c48 - before[1],
            f.launches_async - before[2]) == (1, 0, 0)
    assert torch.equal(dYo, dY)
    assert (dko - dk).abs().max().item() <= 1e-3 * dk.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", [(1, 48, 32, 33), (1, 32, 32, 40), (1, 64, 32, 32)])
def test_outside_e48_never_reaches_it(dev, n, c, h, w):
    """A CUDA tensor outside E48's conditions (W % 8 != 0, channels that pad
    to another width) runs on conv_dw_kernel, and naming E48 for it raises."""
    x, mul, add, dy, ds, y = _inputs(dev, n, c, h, w, seed=2)
    f = bc.conv3x3_dw_cuda
    before = f.launches_c48
    dk, dY = bc.conv3x3_dw(x, dy, y, ds, mul, add)
    torch.cuda.synchronize()
    assert f.launches_c48 == before
    dkp, dYp = bc.conv3x3_dw_plain(x, dy, y, ds, mul, add)
    assert torch.equal(dY, dYp)
    assert (dk - dkp).abs().max().item() <= 1e-3 * dkp.abs().max().item()
    with pytest.raises(ValueError):
        bc.conv3x3_dw_launch(x, dy, y, ds, mul, add, kernel="e48")
    assert f.launches_c48 == before


@pytest.mark.cuda
def test_e48_phase_cycles(dev):
    """E48's stamps: one row per CTA; every CTA's tile loop non-empty and no
    shorter than the consumer phases inside it; its global-timer stamps in
    order (start, loop start, loop end, end); dk as without stamps."""
    x, mul, add, dy, ds, y = _inputs(dev, 8, 48, 128, 128, seed=3)
    dk, dY, cyc = bc.conv3x3_dw_launch(x, dy, y, ds, mul, add, kernel="e48", cycles=True)
    torch.cuda.synchronize()
    assert cyc.shape[1] == len(bc.DW48_PHASES) == 16
    assert bool((cyc[:, 11] > 0).all()) and bool((cyc[:, :12] >= 0).all())
    assert bool((cyc[:, 4:10].sum(dim=1) <= cyc[:, 11]).all())
    assert bool((cyc[:, 13:16] >= cyc[:, 12:15]).all())
    assert torch.equal(dk, bc.conv3x3_dw(x, dy, y, ds, mul, add)[0])
