"""A training cell: the program's trainer, driven as ``train_epoch`` drives
it, with the benchmark's data and weights, then checked against the plain
reference.

Set-up builds one ``Trainer`` (its datasets are the benchmark's: the
program's dataset builder is pointed at them while the trainer is made),
loads the weights made from the seed into the student and its EMA
teacher, and runs the first three steps through the window's own call,
``Trainer.batches`` and ``Trainer.train_step``: their losses, the first
gradient as SGD holds it after one step (its momentum buffer less the
weight decay) and the parameters' change after three are read here.  One
more step warms up, and the window runs steps with no host
synchronisation, each step's end marked on the compute stream, until the
host clock passes ``--seconds``.  A ``--trace 1`` run then profiles
``trace_steps`` more.  After the program's state is freed, the reference
follows the same three steps from the same weights, batches and draws.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import tempfile
import time
from typing import Dict, List

import torch

from port_bench import checks
from port_bench.record import Clock, Run
from port_bench.reference.fixmatch import FixMatchReference
from port_bench.reference.layers import ROUNDINGS
from port_bench.reference.models import build
from port_bench.trace import Trace
from port_bench.traffic import PoolDataset, make_dataset
from port_bench.weights import cell_state

CHECKED_STEPS = 3


def reference_backends() -> None:
    """Float32 as float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def program_seed(seed: int) -> int:
    """The program's ``train.seed``: its loader seeds numpy's shuffle with
    ``seed * 1000003 + epoch``, which has to stay below 2**32."""
    return int(seed) % 4093


@contextlib.contextmanager
def datasets_of(sets: Dict[str, PoolDataset]):
    """While active, the program's trainer and evaluator build the
    benchmark's datasets (by role) in place of the configuration's."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine import evaluator, trainer

    saved = trainer.build_dataset, evaluator.build_dataset
    trainer.build_dataset = evaluator.build_dataset = lambda cfg, role: sets[role]
    try:
        yield
    finally:
        trainer.build_dataset, evaluator.build_dataset = saved


def program_config(cell, seed: int, **overrides):
    from semi_supervised_semantic_segmentation_tpu_torch.config import (
        config_from_dict,
        update_config,
    )

    cfg = config_from_dict(cell.config["config"])
    return update_config(cfg, {"train.seed": program_seed(seed), **overrides})


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _stream(trainer):
    epoch = 0
    while True:
        yield from trainer.batches(epoch)
        epoch += 1


def _step(trainer, stream):
    t0 = time.perf_counter()
    lab, unlab = next(stream)
    waited = time.perf_counter() - t0
    out = trainer.train_step(trainer.state, lab, unlab)
    return lab, unlab, out, waited


def _first_grad_norms(trainer, p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's first gradient, from SGD's state after one step: its
    momentum buffer is the gradient plus the weight decay's term."""
    opt = trainer.state.optimizer
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    out = {}
    for (params, _), bufs in zip(opt.groups, opt.bufs):
        for p, b in zip(params, bufs):
            n = names[id(p)]
            g = b.float() - opt.cfg.weight_decay * p0[n].to(b.device)
            out[n] = float(g.norm())
    return out


def run_train(run: Run, t0: float) -> None:
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer

    cell, dev = run.cell, run.device
    cfgd, traffic = cell.config["config"], cell.traffic
    classes = cfgd["data"]["num_classes"]
    sets = {r: make_dataset(traffic, r, classes, run.seed, dev) for r in ("labeled", "unlabeled")}
    sets["val"] = sets["labeled"]
    state = cell_state(cell, run.seed, sets["labeled"].assemble([0, 1])["image"], dev)
    clock = Clock(dev)
    work = tempfile.mkdtemp(prefix="port_bench_")
    trainer = None
    try:
        cfg = program_config(cell, run.seed, **{"train.work_dir": work})
        if clock.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with datasets_of(sets):
            trainer = Trainer(cfg, dev)
        trainer.model.load_state_dict(state)
        trainer.state.ema_model.load_state_dict(state)
        p0 = {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters()}
        stream = _stream(trainer)
        prog = {"losses": [], "terms": []}
        checked = []
        for k in range(CHECKED_STEPS):
            lab, unlab, out, _ = _step(trainer, stream)
            checked.append((lab["index"].tolist(), unlab["index"].tolist()))
            prog["losses"].append(float(out["loss"]))
            prog["terms"].append([float(out[t]) for t in ("sup_loss", "unsup_loss", "mask_ratio")])
            if k == 0:
                prog["grad"] = _first_grad_norms(trainer, p0)
        prog["change"] = {n: float((p.detach() - p0[n].to(p.device)).norm())
                          for n, p in trainer.model.named_parameters()}
        del p0
        for _ in range(traffic["warm_steps"]):
            _step(trainer, stream)
        clock.sync()
        run.setup_s = time.perf_counter() - t0

        start = clock.mark()
        t_host = time.perf_counter()
        ends, losses = [], []
        while True:
            lab, unlab, out, waited = _step(trainer, stream)
            ends.append(clock.mark())
            losses.append(out["loss"])
            run.data_wait_s.append(waited)
            run.window_images += lab["image"].shape[0] + unlab["image"].shape[0]
            if time.perf_counter() - t_host >= run.seconds:
                break
        clock.sync()
        run.unit_ends_ms = clock.ms(start, ends)
        run.window_ms = run.unit_ends_ms[-1]
        run.attempted = len(ends)
        run.failed = sum(1 for v in losses if not torch.isfinite(v).item())
        if clock.cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated()
        if run.traced:
            run.trace = _profile(trainer, stream, traffic["trace_steps"], clock)
        total_steps = trainer.total_steps
    finally:
        if trainer is not None:
            trainer.close()
        shutil.rmtree(work, ignore_errors=True)
    del trainer, stream, lab, unlab, out, losses
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    batches = [(sets["labeled"].assemble(li), sets["unlabeled"].assemble(ui))
               for li, ui in checked]
    ref = reference_readings(cell, run.seed, state, total_steps, batches, dev)
    run.notes["reference_s"] = time.perf_counter() - t_ref
    readings = checks.training_numbers(prog, ref)
    run.checks = checks.held(readings, cell.limits)
    run.notes.update(readings=readings, worst=checks.worst_leaves(prog, ref),
                     sup_unsup_mask={"program": prog["terms"], "reference": ref["terms"]})


def profiler_activity(clock: Clock):
    """The device's activity alone on the card (its kernels, copies and the
    CUDA runtime calls that launched them): tracing every host operation
    too would slow the host, which paces the step, by a third or more."""
    return torch.profiler.ProfilerActivity.CUDA if clock.cuda else \
        torch.profiler.ProfilerActivity.CPU


def _profile(trainer, stream, steps: int, clock: Clock) -> Trace:
    images = 0
    clock.sync()
    prof = torch.profiler.profile(activities=[profiler_activity(clock)])
    prof.start()
    t0 = time.perf_counter()
    for _ in range(steps):
        lab, unlab, _, _ = _step(trainer, stream)
        images += lab["image"].shape[0] + unlab["image"].shape[0]
    clock.sync()
    wall = time.perf_counter() - t0
    prof.stop()
    return Trace.from_profiler(prof, wall, steps, images)


def reference_readings(cell, seed: int, state: Dict, total_steps: int, batches: List, device,
                       rounding: str = "f32", fault=None) -> Dict:
    """The plain reference's three steps from ``state`` (the weights made
    for ``seed``) on the given host batches: {"losses", "grad", "change"}
    as in :func:`port_bench.checks.training_numbers`.  ``rounding`` ``fp8``
    and ``fault`` make it the control or a planted fault in the program's
    place."""
    reference_backends()
    cfgd = cell.config["config"]
    classes = cfgd["data"]["num_classes"]
    model = build(cfgd["model"], classes, ROUNDINGS[rounding], recompute=True).to(device)
    model.load_state_dict(state)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    ref = FixMatchReference(model, cfgd, total_steps, program_seed(seed), fault)
    out = {"losses": [], "terms": []}
    for k, (lab, unlab) in enumerate(batches):
        step = ref.step(to_device(lab, device), to_device(unlab, device))
        out["losses"].append(step["loss"])
        out["terms"].append([step["sup"], step["unsup"], step["mask"]])
        if k == 0:
            out["grad"] = {n: float(g.norm()) for n, g in step["grads"].items()}
        del step
    out["change"] = {n: float((p.detach() - p0[n]).norm()) for n, p in model.named_parameters()}
    return out
