"""Multi-process helpers of the port's data-parallel tests: a launcher that
runs a function on R CPU ranks joined by gloo, and the functions the ranks
run.  This module imports no JAX: each rank is a fresh interpreter
(``spawn``) that imports only torch and the port.

Every rank seeds nothing of its own: the inputs come from files the test
wrote, and each rank takes its contiguous row block of every global batch
(``parallel.mesh.shard_batch``).  A rank's return value is written with
``torch.save`` and read back by :func:`run_ranks`."""

from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import os
import traceback
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.methods import get_method
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.parallel import mesh as mesh_lib

TIMEOUT_S = 300


def _entry(fn: Callable, rank: int, world: int, tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, tmp: str, *args) -> List[object]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned CPU processes in
    one gloo group; their return values, in rank order.  A rank that fails
    or outlives ``TIMEOUT_S`` fails the call."""
    os.makedirs(tmp, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tmp, args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"ranks exited with {codes}"
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the ranks' functions
# ---------------------------------------------------------------------------


def primitives(rank: int, world: int, path: str) -> Dict[str, object]:
    """The collectives and the pieces of the step that reduce over the batch,
    each on this rank's rows of the global inputs in ``path``: see
    ``tests/test_torch_parallel.py``."""
    from semi_supervised_semantic_segmentation_tpu_torch.models.layers import BatchNorm
    from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv, losses, stem
    from semi_supervised_semantic_segmentation_tpu_torch.ops.cutmix_normalize import (
        cutmix_normalize_plain)

    inp = torch.load(path, weights_only=False)
    mesh = mesh_lib.make_mesh()
    rows = lambda t: mesh_lib.shard_batch({"t": t}, mesh)["t"]  # noqa: E731
    out: Dict[str, object] = {"rank": mesh.rank, "shape": mesh.shape}

    # all_reduce_sum: value, gradient, and under torch.func.vmap
    w = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, requires_grad=True)
    s = mesh_lib.all_reduce_sum(w * (rank + 1), mesh)
    (s * torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64) * (rank + 1)).sum().backward()
    out["ars_value"], out["ars_grad"] = s.detach(), w.grad
    v = torch.arange(6.0, dtype=torch.float64).reshape(2, 3).requires_grad_()
    y = torch.func.vmap(lambda a: mesh_lib.all_reduce_sum(a * (rank + 1), mesh))(v)
    (y * (rank + 1)).sum().backward()
    out["vmap_value"], out["vmap_grad"] = y.detach(), v.grad

    # gather_rows, bit for bit, and the CutMix partner row
    mine = [t[rank] for t in inp["gather"]]
    out["gather"] = mesh_lib.gather_rows(mine, mesh)
    out["gather_one"] = mesh_lib.gather_rows(mine[0], mesh)
    cm = inp["cutmix"]
    local = [rows(cm[k]) for k in ("images", "labels", "conf", "boxes")]
    partner = mesh_lib.partner_rows(local[:3], mesh)
    out["cutmix"] = cutmix_normalize_plain(*local, cm["mean"], cm["std"], torch.bfloat16,
                                           partner)

    # the losses: this rank's value and its gradient in its logits' rows
    L = inp["losses"]
    for name, fn in losses_cases(mesh).items():
        logits = rows(L["logits"]).clone().requires_grad_()
        other = rows(L["logits2"]).clone().requires_grad_()
        val = fn(logits, other, rows(L["labels"]), rows(L["pseudo"]), rows(L["conf"]),
                 rows(L["valid"]))
        val.backward()
        out[f"loss/{name}"] = (val.detach(), logits.grad, other.grad)
    flat = rows(L["probs"]).reshape(-1)
    out["kth"] = [losses.kth_smallest_nonneg_f32(flat, torch.tensor(k), mesh)
                  for k in L["ks"]]

    # SyncBN in training: output, running statistics, gradients
    bn_in = inp["bn"]
    for dtype in (torch.float32, torch.bfloat16):
        bn = BatchNorm(bn_in["x"].shape[1])
        bn.mesh = mesh
        with torch.no_grad():
            bn.weight.copy_(bn_in["weight"])
            bn.bias.copy_(bn_in["bias"])
        x = rows(bn_in["x"]).to(dtype).clone().requires_grad_()
        yb = bn(x)
        (yb.float() * rows(bn_in["cot"])).sum().backward()
        out[f"bn/{dtype}"] = {"y": yb.detach(), "dx": x.grad, "dweight": bn.weight.grad,
                              "dbias": bn.bias.grad, "mean": bn.running_mean.clone(),
                              "var": bn.running_var.clone()}

    # the mesh forms of B (stem) and D / E (branch conv); the loss term in
    # the statistics, shared by every rank, is counted once (rank 0)
    st = inp["stem"]
    wt = st["w"].clone().requires_grad_()
    ys, ss = stem.stem_conv_bn(rows(st["x"]), wt, mesh)
    loss = (ys.float() * rows(st["co"])).sum() + (rank == 0) * (ss * st["cs"]).sum()
    loss.backward()
    out["stem"] = {"y": ys.detach(), "s": ss.detach(), "dw": wt.grad}
    bc = inp["branch"]
    for pre in (False, True):
        args = [rows(bc["x"]).clone().requires_grad_(), bc["k"].clone().requires_grad_()]
        if pre:
            args += [bc["mul"].clone().requires_grad_(), bc["add"].clone().requires_grad_()]
        yb, sb = branch_conv.conv3x3_bn_nchw(*args, mesh=mesh)
        loss = (yb.float() * rows(bc["co"])).sum() + (rank == 0) * (sb * bc["w"]).sum()
        loss.backward()
        out[f"branch/{pre}"] = {"y": yb.detach(), "s": sb.detach(),
                                "grads": [a.grad for a in args]}
    out["counts"] = dict(mesh_lib.COUNTS)
    return out


def losses_cases(mesh) -> Dict[str, Callable]:
    """Each loss of ``ops/losses.py`` as f(logits, logits2, labels, pseudo,
    conf, valid), with the normalisers of ``mesh``."""
    from semi_supervised_semantic_segmentation_tpu_torch.ops import losses

    return {
        "ce": lambda lg, o, y, p, c, v: losses.cross_entropy(lg, y, mesh=mesh),
        "ce_mask": lambda lg, o, y, p, c, v: losses.cross_entropy(lg, y, extra_mask=v, mesh=mesh),
        "conf_all": lambda lg, o, y, p, c, v: losses.confidence_masked_ce(
            lg, p, c, normalize="all", mesh=mesh),
        "conf_masked": lambda lg, o, y, p, c, v: losses.confidence_masked_ce(
            lg, p, c, normalize="masked", mesh=mesh),
        "mse_mean": lambda lg, o, y, p, c, v: losses.mse_consistency(lg, o, mesh=mesh),
        "mse_classes": lambda lg, o, y, p, c, v: losses.mse_consistency(
            lg, o, reduction="classes", mesh=mesh),
        "mse_mean_valid": lambda lg, o, y, p, c, v: losses.mse_consistency(
            lg, o, valid_mask=v, mesh=mesh),
        "mse_classes_valid": lambda lg, o, y, p, c, v: losses.mse_consistency(
            lg, o, valid_mask=v, reduction="classes", mesh=mesh),
        "cps": lambda lg, o, y, p, c, v: losses.cps_loss(lg, o, valid_mask=v, mesh=mesh),
        "ohem": lambda lg, o, y, p, c, v: losses.ohem_cross_entropy(
            lg, y, thresh=0.3, min_kept=50, mesh=mesh),
        "ohem_all": lambda lg, o, y, p, c, v: losses.ohem_cross_entropy(
            lg, y, thresh=0.3, min_kept=100000, mesh=mesh),
    }


def _flat(ts) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).double() for t in ts])


def step_record(state) -> Dict[str, torch.Tensor]:
    """The state after a step: every net's gradient as one vector, its
    parameters and buffers, the momentum, and the EMA teacher's tensors."""
    nets = state.nets()
    params = [p for n in nets for p in n.parameters()]
    rec = {"grad": _flat([p.grad if p.grad is not None else torch.zeros_like(p)
                          for p in params]),
           "params": _flat(params),
           "buffers": _flat([b for n in nets for b in n.buffers()]),
           "momentum": _flat([b for bufs in state.optimizer.bufs for b in bufs])}
    if state.ema_model is not None:
        rec["teacher"] = _flat(list(state.ema_model.parameters())
                               + list(state.ema_model.buffers()))
    return rec


def digests(rec: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """sha256 of each vector's bytes: equal digests are bit-equal states."""
    return {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
            for k, v in rec.items() if isinstance(v, torch.Tensor)}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def to_float64(state, cfg) -> None:
    """Every net of ``state`` (the teacher included) in float64: parameters,
    buffers and compute dtype, and a fresh SGD over them
    (``tests/test_torch_cps.py``)."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine.state import SGD

    for net in state.nets() + [n for n in (state.ema_model,) if n is not None]:
        net.double()
        for mod in net.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.float64
    state.optimizer = SGD(cfg, state.nets(), 1)


def one_step(raw: dict, lab: dict, unlab, mesh=None, perturb: float = 0.0) -> Dict[str, object]:
    """One step of ``raw``'s method from its seeded weights, in float64
    (:func:`to_float64`), on ``lab`` / ``unlab`` (numpy; this rank's rows of
    them under ``mesh``) with the step's own draws (``train.seed``, step 0).
    ``perturb``: the f32 weights first scaled by 1 + perturb * N(0, 1) (a
    control of the step's sensitivity)."""
    cfg = config.config_from_dict(raw)
    method = get_method(cfg.method.name)
    model = build_model(cfg, mesh=mesh)
    if perturb:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
    state = method.init_state(cfg, model, 1)
    to_float64(state, cfg)
    step = method.make_train_step(cfg, 1, mesh)
    shard = lambda b: None if b is None else {  # noqa: E731
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in mesh_lib.shard_batch(b, mesh).items()}
    before = dict(mesh_lib.COUNTS)
    metrics = step(state, shard(lab), shard(unlab))
    after = dict(mesh_lib.COUNTS)
    rec = step_record(state)
    rec["metrics"] = {k: float(v) for k, v in metrics.items()}
    rec["collectives"] = after["collectives"] - before["collectives"]
    return rec


def ddp_steps(rank: int, world: int, cases: list, model_parallel: int = 1) -> List[dict]:
    """:func:`one_step` of each (raw, lab, unlab, control) case on this rank's
    block under a (world / M) x M mesh, M = ``model_parallel``: its digests,
    scalars, collectives and the spatial stem's halo and gather launches.
    Rank 0 also runs the one-process step on the whole batch (no group) and
    returns each vector's relative distance to it, the one-process scalars
    and, where ``control``, the distances of the control (the one-process
    step with its weights perturbed by 1e-7)."""
    from semi_supervised_semantic_segmentation_tpu_torch.parallel import spatial

    mesh = mesh_lib.make_mesh(-1, model_parallel)
    out = []
    for raw, lab, unlab, control in cases:
        before = dict(spatial.COUNTS)
        rec = one_step(raw, lab, unlab, mesh)
        res = {"digest": digests(rec), "metrics": rec["metrics"],
               "collectives": rec["collectives"],
               "spatial": {k: spatial.COUNTS[k] - before[k] for k in before},
               "coords": (mesh.rank, mesh.model_rank, mesh.world_rank)}
        if rank == 0:
            ref = one_step(raw, lab, unlab)
            res["rel"] = {k: rel(rec[k], ref[k]) for k in digests(ref)}
            res["ref_metrics"] = ref["metrics"]
            res["ref_collectives"] = ref["collectives"]
            if control:
                ctl = one_step(raw, lab, unlab, perturb=1e-7)
                res["control_rel"] = {k: rel(ctl[k], ref[k]) for k in digests(ref)}
        out.append(res)
    return out


def replayed_step(rank: int, world: int, raw: dict, state_dict: dict, lab: dict,
                  weak: dict) -> Dict[str, object]:
    """One supervised step from ``state_dict`` with the weak draws ``weak``
    (the global batch's, replayed from the reference): this rank's rows."""
    from semi_supervised_semantic_segmentation_tpu_torch.methods import supervised
    from semi_supervised_semantic_segmentation_tpu_torch.ops import augment

    mesh = mesh_lib.make_mesh()
    cfg = config.config_from_dict(raw)
    state = supervised.init_state(cfg, build_model(cfg, mesh=mesh), 1)
    state.model.load_state_dict(state_dict)
    rows = lambda t: mesh_lib.shard_batch({"t": t}, mesh)["t"]  # noqa: E731
    draws = supervised.Draws(weak_l=augment.WeakParams(**{k: rows(v) for k, v in weak.items()}),
                             dropout=None)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in mesh_lib.shard_batch(lab, mesh).items()}
    metrics = supervised.make_train_step(cfg, 1, mesh)(state, batch, None, draws)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


def fit(rank: int, world: int, raw: dict, device: str = "cpu") -> Dict[str, object]:
    """``Trainer.fit`` of ``raw`` on this rank (an epoch, its eval and its
    rolling slot), then the eval's confusion matrix again: see
    ``tests/test_torch_ddp_step.py``."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine import evaluator
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(config.config_from_dict(raw), device=device)
    trainer.fit()
    model = evaluator.inference_model(trainer.state, trainer.method)
    loader = evaluator.val_loader(trainer.cfg, trainer.mesh)
    try:
        cm = evaluator.eval_confusion(trainer.eval_step, model, loader, trainer.device,
                                      mesh=trainer.mesh)
    finally:
        loader.close()
    return {"state": digests(step_record(trainer.state)), "step": trainer.state.step, "cm": cm,
            "best": trainer.best_miou, "mesh": trainer.mesh.shape, "rank": trainer.mesh.rank,
            "world_rank": trainer.mesh.world_rank, "val_rows": trainer.val_loader.local_batch_size}


def resume(rank: int, world: int, raw: dict) -> Dict[str, object]:
    """A Trainer that resumes ``raw``'s ``train.resume``: its restored state."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(config.config_from_dict(raw), device="cpu")
    try:
        return {"state": digests(step_record(trainer.state)), "step": trainer.state.step,
                "start_epoch": trainer.start_epoch}
    finally:
        trainer.close()


def asdict_weak(weak) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(weak, f.name) for f in dataclasses.fields(weak)}


# ---------------------------------------------------------------------------
# spatial H-sharding over a model axis (tests/test_torch_spatial*.py)
# ---------------------------------------------------------------------------


def spatial_primitives(rank: int, world: int, cases: List[dict]) -> List[dict]:
    """Each case ({"data", "model", "op", "x", "w", "cot"}: whole NCHW x, OIHW
    w, the output's cotangent) on this rank's block under a data x model
    mesh: the op's f32 output block, its float64 output block and the
    float64 gradients of sum(y * cot) in this rank's x block and in w; then
    the mesh's ranks and the collectives each op launched."""
    from semi_supervised_semantic_segmentation_tpu_torch.parallel import spatial

    ops = {"same": spatial.spatial_conv2d_same, "stride2": spatial.spatial_conv2d_stride2,
           "halo": lambda x, w, m: spatial.halo_exchange_h(x, w.shape[2] // 2, m),
           "pull": lambda x, w, m: spatial.halo_pull_prev_h(x, 1, m),
           "gather": lambda x, w, m: spatial.gather_h(x, m)}
    out = []
    for case in cases:
        mesh = mesh_lib.make_mesh(case["data"], case["model"])
        op = ops[case["op"]]
        # this rank's block: its data rank's rows of N, its model rank's of H
        x = spatial.shard_h(mesh_lib.shard_batch({"t": case["x"]}, mesh)["t"], mesh)
        before = dict(spatial.COUNTS)
        y32 = op(x.float(), case["w"].float(), mesh)
        x64 = x.double().requires_grad_()
        w64 = case["w"].double().requires_grad_()
        y = op(x64, w64, mesh)
        rows = mesh_lib.shard_batch({"t": case["cot"]}, mesh)["t"]
        cot = (rows if case["op"] == "gather" else spatial.shard_h(rows, mesh)).double()
        (y * cot).sum().backward()
        out.append({"y32": y32.detach(), "y": y.detach(), "dx": x64.grad,
                    "dw": w64.grad if w64.grad is not None else torch.zeros_like(w64),
                    "coords": (mesh.rank, mesh.model_rank, mesh.world_rank),
                    "counts": {k: spatial.COUNTS[k] - before[k] for k in before}})
    return out


def spatial_hrnet(rank: int, world: int, flat: Dict[str, np.ndarray], x: np.ndarray,
                  model_parallel: int) -> Dict[str, object]:
    """A width-8 HRNet (f32, ``stage_modules`` (1, 1, 1)) with the weights
    ``flat`` (torch layout) on this rank's rows of the NHWC ``x`` under a
    (world / M) x M mesh: the taps in eval mode, then in train mode (no
    gradient) with the running statistics it leaves, and the stem's
    collectives."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
    from semi_supervised_semantic_segmentation_tpu_torch.models.hrnet import HRNet
    from semi_supervised_semantic_segmentation_tpu_torch.models.layers import use_mesh
    from semi_supervised_semantic_segmentation_tpu_torch.parallel import spatial

    mesh = mesh_lib.make_mesh(-1, model_parallel)
    net = HRNet(8, stage_modules=(1, 1, 1), compute_dtype=torch.float32)
    compat.load_flat(net, flat)
    use_mesh(net, mesh)
    xb = mesh_lib.shard_batch({"x": torch.from_numpy(x)}, mesh)["x"]
    before = dict(spatial.COUNTS)
    with torch.no_grad():
        taps_eval = net.eval()(xb)
        taps_train = net.train()(xb)
    return {"eval": taps_eval, "train": taps_train,
            "stats": {k: v.clone() for k, v in net.state_dict().items() if "running_" in k},
            "coords": (mesh.rank, mesh.model_rank, mesh.world_rank),
            "counts": {k: spatial.COUNTS[k] - before[k] for k in before}}
