"""The port's branch conv (``ops/branch_conv.py``: kernels D and E, run here
as their plain versions) against the reference's Pallas kernels in
interpret mode (``ops/pallas_conv.py``), at the shapes and tolerances of
tests/test_pallas_conv.py.  Inputs come from numpy with a seed and cross as
bf16; the reference's HWIO weights are the port's OIHW transposed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu.ops import pallas_conv
from semi_supervised_semantic_segmentation_tpu_torch.engine.compat import conv_flax_to_torch
from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv as bc


def _bf16_pair(a):
    """numpy f32 -> (JAX bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("shape,c", [((2, 8, 64, 16), 8), ((1, 48, 32, 128), 48)])
def test_conv3x3_nchw_forward_matches_pallas(shape, c):
    rng = np.random.RandomState(0)
    xj, xt = _bf16_pair(rng.randn(*shape).astype(np.float32))
    k = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    want = pallas_conv.conv3x3_nchw(xj, jnp.asarray(k), interpret=True)
    got = bc.conv3x3_nchw(xt, torch.from_numpy(conv_flax_to_torch(k)))
    assert got.dtype == torch.bfloat16
    # test_pallas_conv's bound: one bf16 ulp from f32 summation order
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_conv3x3_nchw_grads_match_pallas():
    rng = np.random.RandomState(1)
    xj, xt = _bf16_pair(rng.randn(2, 8, 64, 16).astype(np.float32))
    k = (rng.randn(3, 3, 8, 8) * 0.1).astype(np.float32)

    def loss_j(x, kk):
        return jnp.sum(pallas_conv.conv3x3_nchw(x, kk, True).astype(jnp.float32) ** 2)

    gx_j, gk_j = jax.grad(loss_j, argnums=(0, 1))(xj, jnp.asarray(k))
    xt.requires_grad_()
    kt = torch.from_numpy(conv_flax_to_torch(k)).requires_grad_()
    (bc.conv3x3_nchw(xt, kt).float() ** 2).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), _np(gx_j), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(kt.grad), conv_flax_to_torch(np.asarray(gk_j)),
                               rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("with_pre", [True, False])
def test_conv3x3_bn_nchw_matches_pallas(with_pre):
    """y, the [2,C] statistics and every gradient (x, k and, with the input
    transform, mul and add) of the fused op, with a loss that reads both
    outputs so the statistics' cotangent reaches the weight gradient."""
    _bn_op_matches_pallas(with_pre)


def test_conv3x3_bn_nchw_matches_pallas_post(monkeypatch):
    """The backward of the op with the input transform runs D's post mode
    (here its plain version) always; against the reference with
    SSTPU_CBR_DX_FUSE=1, which runs its ``post`` kernel in interpret mode:
    the same four gradients."""
    monkeypatch.setenv("SSTPU_CBR_DX_FUSE", "1")
    pallas_conv._cbr_fn.cache_clear()
    try:
        _bn_op_matches_pallas(True)
    finally:
        pallas_conv._cbr_fn.cache_clear()


def _bn_op_matches_pallas(with_pre):
    rng = np.random.RandomState(5)
    c = 48
    xj, xt = _bf16_pair(rng.randn(2, c, 64, 64).astype(np.float32))
    k = (rng.randn(3, 3, c, c) * 0.05).astype(np.float32)
    mul = (rng.rand(c) + 0.5).astype(np.float32)
    add = (rng.randn(c) * 0.1).astype(np.float32)
    coj, cot = _bf16_pair(rng.randn(2, c, 64, 64).astype(np.float32))
    w1 = (rng.randn(c) * 0.1).astype(np.float32)
    w2 = (rng.randn(c) * 0.01).astype(np.float32)
    pre = (mul, add) if with_pre else ()

    def loss_j(x, kk, *p):
        y, s = pallas_conv.conv3x3_bn_nchw(x, kk, *p, interpret=True)
        return (jnp.vdot(y.astype(jnp.float32), coj.astype(jnp.float32))
                + jnp.vdot(s[0], w1) + jnp.vdot(s[1], w2)), (y, s)

    args_j = (xj, jnp.asarray(k), *map(jnp.asarray, pre))
    (_, (y_j, s_j)), g_j = jax.value_and_grad(loss_j, argnums=tuple(range(len(args_j))),
                                              has_aux=True)(*args_j)
    args_t = [xt, torch.from_numpy(conv_flax_to_torch(k)), *map(torch.from_numpy, pre)]
    for a in args_t:
        a.requires_grad_()
    y_t, s_t = bc.conv3x3_bn_nchw(*args_t)
    ((y_t.float() * cot.float()).sum() + (s_t[0] * torch.from_numpy(w1)).sum()
     + (s_t[1] * torch.from_numpy(w2)).sum()).backward()

    np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(s_t), _np(s_j), rtol=2e-2, atol=2e-1)
    names = ("dx", "dk", "dmul", "dadd")
    # test_pallas_conv's bounds; dmul/dadd are per-channel reductions of
    # cancellation-heavy bf16 products summed in another order
    tol = {"dx": 2e-2, "dk": 2e-2, "dmul": 8e-2, "dadd": 8e-2}
    for name, a, b in zip(names, args_t, g_j):
        want = _np(b)
        if name == "dk":
            want = conv_flax_to_torch(want)
        rel = np.max(np.abs(_np(a.grad) - want)) / (np.max(np.abs(want)) + 1e-6)
        assert rel < tol[name], f"{name}: max-rel {rel}"


def test_supported_is_the_reference_gate():
    shapes = [((2, 8, 64, 16), 8, 8), ((2, 8, 48, 16), 8, 8), ((2, 192, 64, 16), 192, 192),
              ((2, 8, 64, 16), 8, 16), ((1, 128, 32, 7), 128, 128), ((1, 8, 0, 8), 8, 8)]
    for shape, ci, co in shapes:
        assert bc.supported(shape, ci, co) == pallas_conv.supported(shape, ci, co), shape
    assert bc.supported((2, 8, 64, 16), 8, 8) and not bc.supported((1, 8, 0, 8), 8, 8)


@pytest.mark.parametrize("shape,ptrs,ring", [
    ((8, 48, 256, 256), (0x7f0000000000, 0x7f0000400000, 0x7f0000800000), True),
    ((8, 96, 128, 128), (0x7f0000000000, 0x7f0000400000), True),
    ((2, 48, 32, 40), (256, 512), True),       # ragged last column tile, still whole chunks
    ((2, 48, 32, 70), (256, 512), False),      # W % 8 != 0: rows do not start on a chunk
    ((1, 96, 64, 33), (256, 512), False),
    ((2, 48, 32, 64), (258, 512), False),      # x 2 bytes past a 16-byte boundary
    ((2, 48, 32, 64), (256, 512, 520), False),  # y 8 bytes past it
    ((1, 96, 32, 8), (16, 32), True),
    ((1, 128, 32, 8), (16, 32), True),
])
def test_dw_path_choice(shape, ptrs, ring):
    """E's staging path is a function of the shape and the addresses alone,
    decided before the launch: the asynchronous ring for W % 8 == 0 and
    16-byte aligned tensors, the synchronous fill for anything else."""
    assert bc.dw_async(shape, ptrs) is ring


@pytest.mark.parametrize("shape,ptrs,c96", [
    ((8, 96, 128, 128), (0x7f0000000000, 0x7f0000400000), True),  # config 5's branch 1
    ((8, 48, 256, 256), (0x7f0000000000, 0x7f0000400000), False),  # branch 0: D48, not D96
    ((1, 88, 32, 64), (256, 512), True),        # pads to 96
    ((1, 80, 32, 64), (256, 512), False),       # pads to 80
    ((1, 128, 32, 64), (256, 512), False),
    ((1, 96, 32, 72), (256, 512, 768), True),   # ragged last column tile, whole chunks
    ((1, 96, 64, 33), (256, 512), False),       # W % 8 != 0
    ((1, 96, 32, 64), (258, 512), False),       # x 2 bytes past a 16-byte boundary
    ((1, 96, 32, 64), (256, 512, 520), False),  # post's x 8 bytes past it
])
def test_fwd_kernel_choice(shape, ptrs, c96):
    """D's kernel is a function of the shape and the addresses alone,
    decided before the launch: D96 for channels that pad to 96, W % 8 == 0
    and 16-byte aligned activations, conv_fwd_kernel for anything else."""
    assert bc.fwd_c96(shape, ptrs) is c96


@pytest.mark.parametrize("shape,ptrs,kern", [
    ((8, 48, 256, 256), (0x7f0000000000, 0x7f0000400000), 48),  # config 5's branch 0
    ((8, 48, 256, 256), (0x7f0000000000, 0x7f0000400000, 0x7f0000800000), 48),  # post
    ((8, 96, 128, 128), (0x7f0000000000, 0x7f0000400000), 96),  # branch 1: D96, never D48
    ((2, 40, 32, 64), (256, 512), 48),          # pads to 48
    ((2, 33, 32, 64), (256, 512), 48),
    ((2, 32, 32, 64), (256, 512), 0),           # pads to 32
    ((1, 88, 32, 64), (256, 512), 96),
    ((2, 48, 32, 40), (256, 512, 768), 48),     # ragged last column tile, whole chunks
    ((2, 48, 32, 70), (256, 512), 0),           # W % 8 != 0
    ((2, 48, 32, 64), (258, 512), 0),           # x 2 bytes past a 16-byte boundary
    ((2, 48, 32, 64), (256, 520), 0),           # y 8 bytes past it
    ((2, 48, 32, 64), (256, 512, 770), 0),      # post's x 2 bytes past it
])
def test_fwd48_kernel_choice(shape, ptrs, kern):
    """D's kernel among D96, D48 and conv_fwd_kernel is a function of the
    shape and the addresses alone, decided before the launch: D48 for
    channels that pad to 48, W % 8 == 0 and 16-byte aligned activations
    (post's x included); a width that pads to 96 goes to D96 and never to
    D48; anything else to conv_fwd_kernel (0)."""
    assert bc.fwd_c48(shape, ptrs) is (kern == 48)
    assert bc.fwd_c96(shape, ptrs) is (kern == 96)
    assert bc.fwd_kernel(shape, ptrs) == kern


def _d96_slab_matrix(slab: torch.Tensor, cp: int = 96) -> torch.Tensor:
    """One tap's packed slab of D96 (cp = 96) or D48 (cp = 48) read as wgmma
    reads B through its descriptor (K-major core matrices, no swizzle):
    element (n = co, k = ci) at byte (ci // 8) * w_lbo + (co // 8) * sbo +
    (co % 8) * 16 + (ci % 8) * 2.  -> [co, ci]."""
    p = bc.operand_plan(cp)
    flat = slab.reshape(-1)
    co = torch.arange(cp)[:, None]
    ci = torch.arange(cp)[None, :]
    byte = (ci // 8) * p["w_lbo"] + (co // 8) * p["sbo"] + (co % 8) * 16 + (ci % 8) * 2
    return flat[byte // 2]


@pytest.mark.parametrize("c,flip", [(96, False), (88, True), (48, False), (48, True), (40, True)])
def test_packed_weights96_are_the_conv_as_tap_gemms(c, flip):
    """The packed weights of D96 ([9, 12, 96, 8]) and D48 ([9, 6, 48, 8]):
    per tap, wgmma's B in core matrices of 8 C_out x 8 ci, read here
    through its descriptor's strides, as nine per-tap GEMMs over shifted
    inputs give the plain D (flipped: the dx conv) bit for bit in f32, and
    are 0 beyond C."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(1, c, 8, 16, generator=g).to(torch.bfloat16)
    w = torch.randn(c, c, 3, 3, generator=g) * 0.1
    wp = bc.pack_weights_plain(w, flip)
    assert wp.dtype == torch.bfloat16
    cp = 96 if c > 48 else 48
    assert wp.shape == (9, cp // 8, cp, 8)
    mats = torch.stack([_d96_slab_matrix(wp[tap], cp) for tap in range(9)])
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


def test_plain_versions_hold_the_rounding_contract():
    """The plain D rounds the input transform twice and pads the
    TRANSFORMED input with zeros; the plain E's dY is the f32 composition
    rounded once (bit for bit the stem's fold)."""
    g = torch.Generator().manual_seed(0)
    c = 8
    x = torch.randn(1, c, 32, 8, generator=g).to(torch.bfloat16)
    w = torch.randn(c, c, 3, 3, generator=g)
    mul, add = torch.rand(c, generator=g) + 0.5, torch.rand(c, generator=g) + 0.1
    t = bc.transform_input(x, mul, add)
    want = ((x.float() * mul.to(torch.bfloat16).float()[None, :, None, None]).to(torch.bfloat16)
            .float() + add.to(torch.bfloat16).float()[None, :, None, None]).to(torch.bfloat16)
    assert torch.equal(t, want.clamp_min(0))
    # add > 0 makes relu(add) > 0 outside the image: zero padding must win
    y, _ = bc.conv3x3_fwd_plain(x, w, mul, add)
    yp = torch.nn.functional.conv2d(torch.nn.functional.pad(t.float(), (1, 1, 1, 1)),
                                    w.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(y, yp)
    dy = torch.randn(x.shape, generator=g).to(torch.bfloat16)
    ds = torch.randn(2, c, generator=g)
    _, dY = bc.conv3x3_dw_plain(x, dy, y, ds)
    f = (dy.float() + ds[0][None, :, None, None]) + (2.0 * y.float()) * ds[1][None, :, None, None]
    assert torch.equal(dY, f.to(torch.bfloat16))


def _pallas_dx(dYj, k, post=None):
    """The reference's dx conv (``_cbr_fn``'s ``dx_conv``, or with post
    ``dx_conv_post``) in interpret mode; k HWIO f32 of the forward conv."""
    k_bwd = jnp.transpose(jnp.asarray(k)[::-1, ::-1], (0, 1, 3, 2))
    return pallas_conv._conv3x3_nchw_impl(
        dYj, pallas_conv._pack_kstack(k_bwd, dYj.dtype), interpret=True, sub=pallas_conv.FWD_SUB,
        variant="kstack", post=post)


@pytest.mark.parametrize("shape", [(2, 16, 64, 32), (1, 48, 32, 128)])
def test_conv3x3_dx_post_plain_matches_pallas_post(shape):
    """D's post mode against the reference's ``post`` kernel in interpret
    mode: dx within the conv's one-ulp bound, its zeros (the ReLU mask)
    where both sides' dt is non-zero, (dmul, dadd) within the bounds of the
    op's other per-channel reductions."""
    rng = np.random.RandomState(11)
    c = shape[1]
    xj, xt = _bf16_pair(rng.randn(*shape).astype(np.float32))
    dYj, dYt = _bf16_pair(rng.randn(*shape).astype(np.float32))
    k = (rng.randn(3, 3, c, c) * 0.05).astype(np.float32)
    mul = (rng.rand(c) + 0.5).astype(np.float32)
    add = (rng.randn(c) * 0.1).astype(np.float32)
    mul_r = jnp.asarray(mul).astype(jnp.bfloat16).astype(jnp.float32)[:, None]
    add_r = jnp.asarray(add).astype(jnp.bfloat16).astype(jnp.float32)[:, None]
    dx_j, s_j = _pallas_dx(dYj, k, post=(xj, mul_r, add_r, jnp.asarray(mul)[:, None]))
    dt_j = _pallas_dx(dYj, k)
    wt = torch.from_numpy(conv_flax_to_torch(k))
    dx_t, s_t = bc.conv3x3_dx_post_plain(dYt, wt, xt, torch.from_numpy(mul), torch.from_numpy(add))
    dt_t = bc.conv3x3_fwd_plain(dYt, wt, stats=False, flip=True)[0]
    assert dx_t.dtype == torch.bfloat16 and s_t.shape == (2, c) and s_t.dtype == torch.float32
    np.testing.assert_allclose(_np(dx_t), _np(dx_j), rtol=2e-2, atol=2e-2)
    both = (_np(dt_t) != 0) & (_np(dt_j) != 0)
    assert both.mean() > 0.9
    np.testing.assert_array_equal((_np(dx_t) == 0)[both], (_np(dx_j) == 0)[both])
    for row, name in enumerate(("dmul", "dadd")):
        want = _np(s_j)[row]
        rel = np.max(np.abs(_np(s_t)[row] - want)) / (np.max(np.abs(want)) + 1e-6)
        assert rel < 8e-2, f"{name}: max-rel {rel}"


def test_backward_takes_the_post_mode_and_equals_the_unfused_chain_on_the_cpu(monkeypatch):
    """The backward of the op with the input transform calls D's post mode
    once per call, whatever SSTPU_CBR_DX_FUSE says.  On the CPU it is the
    plain arithmetic of the chain it replaces (E, D's dx conv, then
    ``pre_backward``), so the four gradients are bit-equal to that chain's."""
    g = torch.Generator().manual_seed(2)
    c = 16
    x = torch.randn(2, c, 32, 24, generator=g).to(torch.bfloat16)
    w = torch.randn(c, c, 3, 3, generator=g) * 0.1
    mul, add = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1
    co, ws = torch.randn(2, c, 32, 24, generator=g), torch.randn(2, c, generator=g) * 0.1
    calls = []
    post = bc.conv3x3_dx_post
    monkeypatch.setattr(bc, "conv3x3_dx_post", lambda *a: calls.append(1) or post(*a))

    y, _ = bc.conv3x3_fwd_plain(x, w, mul, add)
    dk, dY = bc.conv3x3_dw_plain(x, co.to(torch.bfloat16), y, ws, mul, add)
    dt = bc.conv3x3_fwd_plain(dY, w, stats=False, flip=True)[0]
    dx, dmul, dadd = bc.pre_backward(x, dt, mul, add)
    want = [dx, dk, dmul, dadd]
    for env in ("0", "1", None):
        if env is None:
            monkeypatch.delenv("SSTPU_CBR_DX_FUSE", raising=False)
        else:
            monkeypatch.setenv("SSTPU_CBR_DX_FUSE", env)
        before = len(calls)
        args = [t.clone().requires_grad_() for t in (x, w, mul, add)]
        y, s = bc.conv3x3_bn_nchw(*args)
        ((y.float() * co).sum() + (s * ws).sum()).backward()
        assert len(calls) - before == 1
        for got, exp in zip((a.grad for a in args), want):
            assert torch.equal(got, exp)


def test_dx_post_dispatch_refuses_other_devices():
    t = torch.empty(1, 8, 32, 8, dtype=torch.bfloat16, device="meta")
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bc.conv3x3_dx_post(t, torch.empty(8, 8, 3, 3, device="meta"), t, v, v)
