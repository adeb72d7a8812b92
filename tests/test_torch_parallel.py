"""The port's data parallelism (``…_torch/parallel/``) piece by piece, on two
CPU ranks joined by gloo (one spawn for the whole file,
``tests/torch_ddp_workers.py::primitives``) against one process on the
gathered global batch, and the mesh forms of kernels B and D against the
JAX package's own (``pallas_stem.stem_conv_bn_s2(..., mesh)`` and
``pallas_conv.conv3x3_bn_nchw(..., mesh)`` on a 2-device mesh, Pallas in
interpret mode):

- ``all_reduce_sum``: the value, its gradient (the cotangent summed over
  ranks) and its ``vmap`` rule; ``gather_rows`` bit for bit (-0.0, NaN,
  bf16 and bool rows); kernel A's plain version with the partner row from
  the previous rank, equal to the global roll bit for bit;
- each loss of ``ops/losses.py`` on 2 ranks: the ranks' values sum to the
  one-process value and their gradients are its rows (1e-6), OHEM's
  order statistic bit-equal;
- ``BatchNorm`` on 2 ranks (SyncBN) against ``F.batch_norm`` on the whole
  batch, in f32 and bf16;
- the stem (B, C) and the branch conv (D, E; as is and ``pre``) mesh forms:
  y, the [2,C] statistics and every gradient, at the tolerances of the
  unsharded tests (``tests/test_torch_stem.py``,
  ``tests/test_torch_branch_conv.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semi_supervised_semantic_segmentation_tpu.ops import pallas_conv, pallas_stem
from semi_supervised_semantic_segmentation_tpu.parallel import mesh as jmesh
from semi_supervised_semantic_segmentation_tpu_torch.engine.compat import conv_flax_to_torch
from semi_supervised_semantic_segmentation_tpu_torch.ops import losses
from semi_supervised_semantic_segmentation_tpu_torch.ops.cutmix_normalize import (
    cutmix_normalize_plain,
)
from semi_supervised_semantic_segmentation_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_ddp_workers import losses_cases, primitives, run_ranks
from tests.torch_port_helpers import one_torch_thread

R = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _inputs() -> dict:
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    gather = [t(rng.randn(R, 3, 5).astype(np.float32)),
              t(rng.rand(R, 7) > 0.5),
              t(rng.randn(R, 4).astype(np.float32)).to(torch.bfloat16),
              t(rng.randint(-9, 9, (R, 2, 2)).astype(np.int64))]
    gather[0][0, 0, 0], gather[0][1, 0, 1] = -0.0, float("nan")
    b, h, w = 4, 16, 24
    u = torch.from_numpy(rng.rand(b, 4).astype(np.float32))
    from semi_supervised_semantic_segmentation_tpu_torch.ops import augment

    cutmix = {"images": t(rng.rand(b, h, w, 3).astype(np.float32)),
              "labels": t(rng.randint(0, 5, (b, h, w)).astype(np.int32)),
              "conf": t(rng.rand(b, h, w) > 0.5), "boxes": augment.cutmix_boxes(u, h, w, 1.0),
              "mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)}
    n, c, s = 4, 5, 8
    labels = rng.randint(0, c, (n, s, s))
    labels[rng.rand(n, s, s) < 0.2] = 255
    logits = rng.randn(n, c, s, s).astype(np.float32) * 2
    probs = rng.rand(n, s, s).astype(np.float32)
    probs[rng.rand(n, s, s) < 0.3] = np.inf
    probs[0, 0, :3] = probs[1, 1, 1]  # ties across ranks
    loss_in = {"logits": t(logits), "logits2": t(rng.randn(n, c, s, s).astype(np.float32)),
               "labels": t(labels.astype(np.int32)),
               "pseudo": t(np.where(rng.rand(n, s, s) < 0.1, 255,
                                    rng.randint(0, c, (n, s, s))).astype(np.int32)),
               "conf": t(rng.rand(n, s, s) > 0.4), "valid": t(rng.rand(n, s, s) > 0.25),
               "probs": t(probs), "ks": [0, 7, 100, int(np.isfinite(probs).sum()) - 1]}
    bn = {"x": t((rng.randn(4, 6, 5, 7) * 2 + 3).astype(np.float32)),
          "weight": t(rng.rand(6).astype(np.float32) + 0.5),
          "bias": t(rng.randn(6).astype(np.float32)),
          "cot": t(rng.randn(4, 6, 5, 7).astype(np.float32))}
    stem = {"x": t(rng.rand(4, 64, 256, 3).astype(np.float32)).to(torch.bfloat16),
            "w": t(((rng.rand(7, 7, 3, 64) - 0.5) * 0.2).astype(np.float32)),
            "co": t(rng.randn(4, 64, 32, 128).astype(np.float32)),
            "cs": t(rng.randn(2, 64).astype(np.float32) * 0.1)}
    cb = 8
    branch = {"x": t(rng.randn(4, cb, 64, 16).astype(np.float32)).to(torch.bfloat16),
              "k": t((rng.randn(3, 3, cb, cb) * 0.1).astype(np.float32)),
              "mul": t(rng.rand(cb).astype(np.float32) + 0.5),
              "add": t(rng.randn(cb).astype(np.float32) * 0.1),
              "co": t(rng.randn(4, cb, 64, 16).astype(np.float32)).to(torch.bfloat16).float(),
              "w": t(rng.randn(2, cb).astype(np.float32) * 0.1)}
    return {"gather": gather, "cutmix": cutmix, "losses": loss_in, "bn": bn, "stem": stem,
            "branch": branch}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(global inputs, every rank's results): one spawn of two ranks."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    path = str(tmp / "inputs.pt")
    # the branch conv's weight crosses in the port's OIHW layout
    port_inp = {**inp, "stem": {**inp["stem"], "w": inp["stem"]["w"].permute(3, 2, 0, 1)
                                .contiguous()},
                "branch": {**inp["branch"],
                           "k": torch.from_numpy(conv_flax_to_torch(inp["branch"]["k"].numpy()))}}
    torch.save(port_inp, path)
    outs = run_ranks(primitives, R, str(tmp / "ranks"), path)
    return inp, outs


def _cat(outs, get):
    return torch.cat([get(o) for o in outs])


def test_mesh_without_a_group_is_the_identity():
    """One process, no torch.distributed: one rank, no group, and every
    collective returns its input and launches nothing."""
    mesh = mesh_lib.make_mesh(-1, 1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0 and mesh.group is None
    before = dict(mesh_lib.COUNTS)
    x = torch.randn(3, 4)
    assert mesh_lib.all_reduce_sum(x, mesh) is x
    assert torch.equal(mesh_lib.gather_rows(x, mesh)[0], x)
    assert torch.equal(mesh_lib.partner_rows([x], mesh)[0], x[-1])
    mesh_lib.broadcast_from_rank0([x], mesh)
    assert mesh_lib.COUNTS == before
    with pytest.raises(ValueError, match="data_parallel=2"):
        mesh_lib.make_mesh(2, 1)
    # a model axis of 2 needs D x 2 processes
    with pytest.raises(ValueError, match="data_parallel x model_parallel"):
        mesh_lib.make_mesh(-1, 2)


def test_shard_batch_is_the_loaders_row_block():
    from semi_supervised_semantic_segmentation_tpu_torch.data.datasets import SyntheticDataset
    from semi_supervised_semantic_segmentation_tpu_torch.data.pipeline import Loader

    ds = SyntheticDataset(5, 12, image_hw=(16, 16), seed=3)
    whole = next(Loader(ds, 6, seed=1, num_workers=1).epoch(0))
    for r in range(3):
        mesh = mesh_lib.Mesh({"data": 3, "model": 1}, r)
        part = next(Loader(ds, 6, seed=1, num_workers=1, process_index=r,
                           process_count=3).epoch(0))
        mine = mesh_lib.shard_batch(whole, mesh)
        for k in whole:
            np.testing.assert_array_equal(mine[k], part[k], err_msg=k)
    assert mesh_lib.concat_rows(mesh_lib.Mesh({"data": 2, "model": 1}, 1), 2, 3).tolist() == \
        [2, 3, 4 + 3, 4 + 4, 4 + 5]


def test_ranks_see_the_mesh(run):
    _, outs = run
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["shape"] == {"data": R, "model": 1} for o in outs)
    assert all(o["counts"]["collectives"] > 0 for o in outs)
    assert outs[0]["counts"] == outs[1]["counts"]


def test_all_reduce_sum_value_gradient_and_vmap(run):
    _, outs = run
    w = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    c = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    for o in outs:
        torch.testing.assert_close(o["ars_value"], 3 * w, rtol=0, atol=0)
        torch.testing.assert_close(o["vmap_value"],
                                   3 * torch.arange(6.0, dtype=torch.float64).reshape(2, 3),
                                   rtol=0, atol=0)
    # L = sum_r (r+1) c . s, s = sum_r (r+1) w: rank r's dL/dw = (r+1) * 3c
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["ars_grad"], (r + 1) * 3 * c, rtol=0, atol=0)
        torch.testing.assert_close(o["vmap_grad"], torch.full((2, 3), 3.0 * (r + 1),
                                                              dtype=torch.float64),
                                   rtol=0, atol=0)


def test_gather_rows_bit_exact(run):
    inp, outs = run
    bits = lambda t: t.reshape(-1).view(torch.uint8)  # noqa: E731
    for o in outs:
        for got, want in zip(o["gather"], inp["gather"]):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(bits(got), bits(want))
        assert torch.equal(bits(o["gather_one"]), bits(inp["gather"][0]))


def test_cutmix_partner_row_equals_the_global_roll(run):
    """A's plain version on each rank's rows with the previous rank's last
    row as row 0's partner: the global batch's CutMix, bit for bit."""
    inp, outs = run
    cm = inp["cutmix"]
    want = cutmix_normalize_plain(cm["images"], cm["labels"], cm["conf"], cm["boxes"],
                                  cm["mean"], cm["std"], torch.bfloat16)
    assert (cm["boxes"][[0, 2], 1] > cm["boxes"][[0, 2], 0]).all()  # boxes on each row 0
    for i in range(3):
        got = _cat(outs, lambda o: o["cutmix"][i])
        assert torch.equal(got, want[i])


@pytest.mark.parametrize("name", list(losses_cases(None)))
def test_loss_on_two_ranks_equals_one_process(run, name):
    inp, outs = run
    L = inp["losses"]
    logits = L["logits"].clone().requires_grad_()
    other = L["logits2"].clone().requires_grad_()
    val = losses_cases(None)[name](logits, other, L["labels"], L["pseudo"], L["conf"],
                                   L["valid"])
    val.backward()
    got = sum(o[f"loss/{name}"][0] for o in outs)
    assert float(val.detach()) > 0
    torch.testing.assert_close(got, val.detach(), rtol=1e-6, atol=1e-7)
    for j, g in ((1, logits.grad), (2, other.grad)):
        if g is None:  # the loss does not read that input
            assert all(o[f"loss/{name}"][j] is None for o in outs)
            continue
        torch.testing.assert_close(_cat(outs, lambda o: o[f"loss/{name}"][j]), g,
                                   rtol=1e-6, atol=1e-7)


def test_ohem_order_statistic_is_global_and_exact(run):
    inp, outs = run
    flat = inp["losses"]["probs"].reshape(-1)
    for i, k in enumerate(inp["losses"]["ks"]):
        want = losses.kth_smallest_nonneg_f32(flat, torch.tensor(k))
        assert float(want) == float(torch.sort(flat).values[k])
        for o in outs:
            assert torch.equal(o["kth"][i], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_syncbn_on_two_ranks_equals_batch_norm_on_the_whole_batch(run, dtype):
    inp, outs = run
    bn = inp["bn"]
    x = bn["x"].to(dtype).clone().requires_grad_()
    w, b = bn["weight"].clone().requires_grad_(), bn["bias"].clone().requires_grad_()
    rm, rv = torch.zeros(6), torch.ones(6)
    y = F.batch_norm(x, rm, rv, w, b, True, 0.1, 1e-5)
    (y.float() * bn["cot"]).sum().backward()
    res = [o[f"bn/{dtype}"] for o in outs]
    tol = {"rtol": 1e-5, "atol": 1e-5} if dtype == torch.float32 else {"rtol": 0, "atol": 0.05}
    torch.testing.assert_close(_cat(res, lambda r: r["y"]).float(), y.detach().float(), **tol)
    gtol = {"rtol": 1e-4, "atol": 1e-4} if dtype == torch.float32 else {"rtol": 0.02, "atol": 0.05}
    torch.testing.assert_close(_cat(res, lambda r: r["dx"]).float(), x.grad.float(), **gtol)
    torch.testing.assert_close(sum(r["dweight"] for r in res), w.grad, **gtol)
    torch.testing.assert_close(sum(r["dbias"] for r in res), b.grad, **gtol)
    for r in res:  # the running statistics: global, the same bits on every rank
        torch.testing.assert_close(r["mean"], rm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r["var"], rv, rtol=1e-5, atol=1e-5)
        assert torch.equal(r["mean"], res[0]["mean"]) and torch.equal(r["var"], res[0]["var"])


def test_stem_mesh_form_equals_the_reference_mesh_form(run):
    """Port ``stem_conv_bn(x, w, mesh)`` on 2 ranks against
    ``pallas_stem.stem_conv_bn_s2(x, w, True, mesh)`` on a 2-device mesh:
    y, the global statistics and dW (the ranks' dW summed)."""
    inp, outs = run
    st = inp["stem"]
    mesh = jmesh.make_mesh(data_parallel=R)
    xj = jnp.asarray(st["x"].float().numpy()).astype(jnp.bfloat16)
    xs = jax.device_put(xj, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", None, None, None)))
    wj, co, cs = (jnp.asarray(st[k].numpy()) for k in ("w", "co", "cs"))

    def loss(w_):
        y, s = pallas_stem.stem_conv_bn_s2(xs, w_, True, mesh)
        return jnp.vdot(y.astype(jnp.float32), co) + jnp.vdot(s, cs), (y, s)

    (_, (yj, sj)), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(wj)
    yt = _cat(outs, lambda o: o["stem"]["y"])
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32), atol=8e-3)
    for o in outs:  # rtol 1e-3 of each row's largest magnitude (test_torch_stem)
        for row in range(2):
            want = np.asarray(sj)[row]
            np.testing.assert_allclose(o["stem"]["s"].numpy()[row], want, rtol=0,
                                       atol=1e-3 * np.abs(want).max())
    dw = sum(o["stem"]["dw"] for o in outs).permute(2, 3, 1, 0).numpy()
    gj = np.asarray(gj)
    np.testing.assert_allclose(dw, gj, rtol=0, atol=5e-3 * np.abs(gj).max())


@pytest.mark.parametrize("pre", [False, True], ids=["as_is", "pre"])
def test_branch_conv_mesh_form_equals_the_reference_mesh_form(run, pre):
    """Port ``conv3x3_bn_nchw(..., mesh)`` on 2 ranks against
    ``pallas_conv.conv3x3_bn_nchw(..., interpret=True, mesh)``: y, the
    global statistics, dx (the ranks' rows) and dk, dmul, dadd (the ranks'
    per-rank values summed) at ``tests/test_torch_branch_conv.py``'s
    tolerances."""
    inp, outs = run
    bc = inp["branch"]
    mesh = jmesh.make_mesh(data_parallel=R)
    xj = jnp.asarray(bc["x"].float().numpy()).astype(jnp.bfloat16)
    xs = jax.device_put(xj, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", None, None, None)))
    co, wv = jnp.asarray(bc["co"].numpy()), jnp.asarray(bc["w"].numpy())
    args = (xs, jnp.asarray(bc["k"].numpy())) + (
        (jnp.asarray(bc["mul"].numpy()), jnp.asarray(bc["add"].numpy())) if pre else ())

    def loss(*a):
        y, s = pallas_conv.conv3x3_bn_nchw(*a, interpret=True, mesh=mesh)
        return jnp.vdot(y.astype(jnp.float32), co) + jnp.vdot(s, wv), (y, s)

    (_, (yj, sj)), gj = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                                                   has_aux=True))(*args)
    res = [o[f"branch/{pre}"] for o in outs]
    np.testing.assert_allclose(_cat(res, lambda r: r["y"]).float().numpy(),
                               np.asarray(yj, np.float32), rtol=2e-2, atol=2e-2)
    for r in res:
        np.testing.assert_allclose(r["s"].numpy(), np.asarray(sj), rtol=2e-2, atol=2e-1)
    got = [_cat(res, lambda r: r["grads"][0])] + [sum(r["grads"][i] for r in res)
                                                   for i in range(1, len(args))]
    tol = {"dx": 2e-2, "dk": 2e-2, "dmul": 8e-2, "dadd": 8e-2}
    for name, a, b in zip(("dx", "dk", "dmul", "dadd"), got, gj):
        want = np.asarray(b, np.float32)
        if name == "dk":
            want = conv_flax_to_torch(want)
        rel = np.max(np.abs(a.float().numpy() - want)) / (np.max(np.abs(want)) + 1e-6)
        assert rel < tol[name], f"{name}: max-rel {rel}"
