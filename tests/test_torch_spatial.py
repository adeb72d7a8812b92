"""The port's spatial H-sharding primitives (``…_torch/parallel/spatial.py``)
on four CPU ranks joined by gloo (one spawn for the whole file,
``tests/torch_ddp_workers.py::spatial_primitives``), each rank holding its
block of N (data axis) and of H (model axis), on a D = 1 x M = 4 and a
D = 2 x M = 2 mesh:

- ``spatial_conv2d_same`` (3x3, and 5x3: a halo of 2 rows) and
  ``spatial_conv2d_stride2`` (HRNet's stem conv) against the JAX package's
  under ``spatially_sharded_call`` on the conftest's fake 8-device mesh,
  from the same numpy inputs, in f32 to atol 1e-5 (``tests/test_spatial.py``'s
  tolerance); their gradients in x and w, summed over the ranks, against
  the unsharded conv's, in float64 to 1e-12;
- ``halo_exchange_h``, ``halo_pull_prev_h`` and ``gather_h``: the forward
  bit for bit against slices of the zero-padded whole tensor, the
  backward against the slices' adjoint, one collective per call;
- one rank: a zero pad that launches nothing; an odd local H and an H
  that does not divide over the model axis raise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from semi_supervised_semantic_segmentation_tpu.parallel import spatial as jspatial
from semi_supervised_semantic_segmentation_tpu_torch.parallel import mesh as mesh_lib
from semi_supervised_semantic_segmentation_tpu_torch.parallel import spatial
from tests.torch_ddp_workers import run_ranks, spatial_primitives
from tests.torch_port_helpers import one_torch_thread

WORLD = 4
MESHES = [(1, 4), (2, 2)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(op: str, data: int, model: int, x_shape, w_shape, seed: int) -> dict:
    """NCHW x and OIHW w from numpy (float64; f32 copies cross to JAX)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*x_shape)
    w = rng.randn(*w_shape)
    n, _, h, wd = x_shape
    kh, kw = w_shape[2], w_shape[3]
    out_c = w_shape[0]
    out_h = {"same": h, "stride2": h // 2, "halo": h + (kh // 2) * 2 * model,
             "pull": h + model, "gather": h}[op]
    out_w = {"same": wd, "stride2": wd // 2}.get(op, wd)
    cot_c = out_c if op in ("same", "stride2") else x_shape[1]
    return {"op": op, "data": data, "model": model, "x": _t(x), "w": _t(w),
            "cot": _t(rng.randn(n, cot_c, out_h, out_w))}


CASES = {
    "same3 1x4": _case("same", 1, 4, (2, 8, 64, 16), (4, 8, 3, 3), 0),
    "same5x3 2x2": _case("same", 2, 2, (4, 4, 32, 8), (6, 4, 5, 3), 1),
    "stride2 1x4": _case("stride2", 1, 4, (2, 8, 64, 16), (4, 8, 3, 3), 3),
    "stride2 2x2": _case("stride2", 2, 2, (4, 8, 64, 16), (4, 8, 3, 3), 4),
    "halo 2x2": _case("halo", 2, 2, (4, 3, 16, 8), (1, 3, 5, 1), 5),
    "pull 1x4": _case("pull", 1, 4, (2, 3, 16, 8), (1, 3, 3, 1), 6),
    "gather 2x2": _case("gather", 2, 2, (4, 3, 16, 8), (1, 3, 1, 1), 7),
    "gather 1x4": _case("gather", 1, 4, (2, 3, 16, 8), (1, 3, 1, 1), 8),
}
CONVS = [k for k in CASES if CASES[k]["op"] in ("same", "stride2")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case: [rank results in world-rank order]}: one spawn of four ranks."""
    outs = run_ranks(spatial_primitives, WORLD, str(tmp_path_factory.mktemp("spatial")),
                     list(CASES.values()))
    return {name: [o[i] for o in outs] for i, name in enumerate(CASES)}


def _assemble(results, key: str, data: int, model: int, dim_h: bool = True) -> torch.Tensor:
    """The whole tensor from the ranks' blocks (rank d·M + m: N block d, H
    block m)."""
    rows = []
    for d in range(data):
        blocks = [results[d * model + m][key] for m in range(model)]
        rows.append(torch.cat(blocks, 2) if dim_h else blocks[0])
    return torch.cat(rows, 0)


def _jax_conv(case) -> np.ndarray:
    """The JAX package's sharded conv on the fake mesh, NCHW f32."""
    devs = np.asarray(jax.devices()[: case["data"] * case["model"]])
    mesh = JMesh(devs.reshape(case["data"], case["model"]), ("data", "model"))
    x = jnp.asarray(case["x"].float().numpy().transpose(0, 2, 3, 1))
    k = jnp.asarray(case["w"].float().numpy().transpose(2, 3, 1, 0))
    fn = {"same": jspatial.spatial_conv2d_same, "stride2": jspatial.spatial_conv2d_stride2}
    xs = jax.device_put(x, NamedSharding(mesh, P("data", "model", None, None)))
    out = jspatial.spatially_sharded_call(lambda xl, ax, n: fn[case["op"]](xl, k, ax, n), mesh, xs)
    return np.asarray(out).transpose(0, 3, 1, 2)


def _global_conv(case, x, w):
    if case["op"] == "same":
        return F.conv2d(x, w, padding=(w.shape[2] // 2, w.shape[3] // 2))
    return F.conv2d(x, w, stride=2, padding=1)


def test_ranks_see_the_data_x_model_mesh(ranks):
    for name, res in ranks.items():
        d, m = CASES[name]["data"], CASES[name]["model"]
        assert [r["coords"] for r in res] == [(i // m, i % m, i) for i in range(d * m)], name


@pytest.mark.parametrize("name", CONVS)
def test_sharded_conv_equals_the_reference_sharded_conv(ranks, name):
    case = CASES[name]
    got = _assemble(ranks[name], "y32", case["data"], case["model"])
    want = _jax_conv(case)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("name", CONVS)
def test_sharded_conv_gradients_equal_the_unsharded_conv(ranks, name):
    case = CASES[name]
    res = ranks[name]
    x = case["x"].clone().requires_grad_()
    w = case["w"].clone().requires_grad_()
    y = _global_conv(case, x, w)
    (y * case["cot"]).sum().backward()
    got_y = _assemble(res, "y", case["data"], case["model"])
    np.testing.assert_allclose(got_y.numpy(), y.detach().numpy(), rtol=1e-12, atol=1e-12)
    dx = _assemble(res, "dx", case["data"], case["model"])
    np.testing.assert_allclose(dx.numpy(), x.grad.numpy(), rtol=1e-12, atol=1e-12)
    dw = sum(r["dw"] for r in res)
    np.testing.assert_allclose(dw.numpy(), w.grad.numpy(), rtol=1e-12, atol=1e-12)
    # one halo collective per forward (f32, float64) and one in the backward
    assert all(r["counts"]["halo"] == 3 and r["counts"]["gather_h"] == 0 for r in res)


@pytest.mark.parametrize("name", ["halo 2x2", "pull 1x4"])
def test_halo_forward_is_exact_and_backward_is_its_adjoint(ranks, name):
    case = CASES[name]
    d, m = case["data"], case["model"]
    x = case["x"].clone().requires_grad_()
    halo = case["w"].shape[2] // 2 if case["op"] == "halo" else 1
    padded = F.pad(x, (0, 0, halo, halo if case["op"] == "halo" else 0))
    h = x.shape[2] // m
    span = h + (2 * halo if case["op"] == "halo" else halo)
    nb = x.shape[0] // d
    loss = 0
    for r, res in enumerate(ranks[name]):
        dr, mr = divmod(r, m)
        want = padded[dr * nb:(dr + 1) * nb, :, mr * h:mr * h + span]
        assert torch.equal(res["y"], want.detach()), (name, r)
        cot_rows = case["cot"][dr * nb:(dr + 1) * nb, :, mr * span:(mr + 1) * span]
        loss = loss + (want * cot_rows).sum()
        assert res["counts"]["halo"] == 3  # f32 and float64 forwards, one backward
    loss.backward()
    dx = _assemble(ranks[name], "dx", d, m)
    np.testing.assert_allclose(dx.numpy(), x.grad.numpy(), rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("name", ["gather 2x2", "gather 1x4"])
def test_gather_h_forward_and_backward(ranks, name):
    """Forward: the whole rows, bit for bit, on every model rank; backward:
    this rank's rows of the cotangent, summed over nothing."""
    case = CASES[name]
    d, m = case["data"], case["model"]
    x, cot = case["x"], case["cot"]
    nb, h = x.shape[0] // d, x.shape[2] // m
    for r, res in enumerate(ranks[name]):
        dr, mr = divmod(r, m)
        assert torch.equal(res["y"], x[dr * nb:(dr + 1) * nb]), (name, r)
        assert torch.equal(res["dx"], cot[dr * nb:(dr + 1) * nb, :, mr * h:(mr + 1) * h]), r
        assert res["counts"]["gather_h"] == 2 and res["counts"]["halo"] == 0


def test_one_rank_pads_with_zeros_and_launches_nothing():
    """``test_halo_exchange_single_device_is_zero_pad``'s counterpart, and
    the stride-2 conv with no model axis equals the plain conv."""
    before = dict(mesh_lib.COUNTS)
    x = torch.ones(1, 1, 4, 4)
    out = spatial.halo_exchange_h(x, 1, None)
    assert out.shape == (1, 1, 6, 4)
    assert float(out[0, 0, 0].sum()) == 0.0 and float(out[0, 0, -1].sum()) == 0.0
    assert torch.equal(spatial.halo_pull_prev_h(x, 1, mesh_lib.make_mesh())[0, 0, 0],
                       torch.zeros(4))
    assert spatial.gather_h(x, None) is x
    rng = np.random.RandomState(9)
    xs, w = _t(rng.randn(2, 3, 8, 6)), _t(rng.randn(5, 3, 3, 3))
    np.testing.assert_allclose(spatial.spatial_conv2d_stride2(xs, w, None).numpy(),
                               F.conv2d(xs, w, stride=2, padding=1).numpy(), rtol=1e-13,
                               atol=1e-13)
    assert mesh_lib.COUNTS == before


def test_odd_local_h_and_indivisible_h_raise():
    with pytest.raises(ValueError, match="local H must be even"):
        spatial.spatial_conv2d_stride2(torch.zeros(1, 3, 7, 8), torch.zeros(4, 3, 3, 3), None)
    mesh = mesh_lib.Mesh({"data": 1, "model": 2}, 0, None, 1, object())
    with pytest.raises(ValueError, match="does not divide"):
        spatial.shard_h(torch.zeros(1, 3, 7, 8), mesh)
    assert spatial.shard_h(torch.arange(8.0).reshape(1, 1, 8, 1), mesh).flatten().tolist() == \
        [4.0, 5.0, 6.0, 7.0]
    with pytest.raises(ValueError, match="needs its process group"):
        spatial.gather_h(torch.zeros(1, 3, 4, 8), mesh_lib.Mesh({"data": 1, "model": 2}))
