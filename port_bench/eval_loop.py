"""An eval cell: the program's evaluator over val batches, on the EMA
teacher of a training state the benchmark made, then checked against
the plain reference.

Set-up makes the state as the trainer does (the configuration's model,
``init_state``: SGD and the teacher) with the seed's weights, points the
program's dataset builder at the benchmark's val images while
``val_loader`` is made, and runs one val batch, which meets every shape
of the protocol.  The window runs whole batches as ``eval_confusion``
does (``common.to_device``, the eval step under ``torch.no_grad``, the
teacher in eval mode), each batch's end marked on the compute stream,
and ends with the batch that crosses ``--seconds``.  A ``--trace 1`` run
then profiles ``trace_steps`` more batches.  Each batch's confusion
matrix has to count every valid pixel of its images once; the reference
recomputes ``check_batches`` of them, drawn from the seed.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict

import torch

from port_bench import checks
from port_bench.record import Clock, Run
from port_bench.reference import evaluate
from port_bench.reference.layers import ROUNDINGS
from port_bench.reference.models import build
from port_bench.trace import Trace
from port_bench.train_loop import (
    profiler_activity,
    datasets_of,
    program_config,
    reference_backends,
    to_device,
)
from port_bench.traffic import make_dataset
from port_bench.weights import cell_state


def _stream(loader):
    epoch = 0
    while True:
        yield from loader.epoch(epoch)
        epoch += 1


def run_eval(run: Run, t0: float) -> None:
    from semi_supervised_semantic_segmentation_tpu_torch.engine.evaluator import (
        inference_model,
        make_evaluator,
        val_loader,
    )
    from semi_supervised_semantic_segmentation_tpu_torch.methods import common, get_method
    from semi_supervised_semantic_segmentation_tpu_torch.models import build_model

    cell, dev = run.cell, run.device
    cfgd, traffic = cell.config["config"], cell.traffic
    classes = cfgd["data"]["num_classes"]
    val = make_dataset(traffic, "val", classes, run.seed, dev)
    weights = cell_state(cell, run.seed, val.assemble([0, 1])["image"], dev)
    clock = Clock(dev)
    cfg = program_config(cell, run.seed)
    if clock.cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    method = get_method(cfg.method.name)
    t = cfg.train
    model = build_model(cfg).to(dev)
    state = method.init_state(cfg, model, t.iters_per_epoch * t.epochs)
    state.model.load_state_dict(weights)
    state.ema_model.load_state_dict(weights)
    with datasets_of({"val": val}):
        loader = val_loader(cfg)
    eval_step = make_evaluator(cfg)
    net = inference_model(state, method)
    net.eval()
    stream = _stream(loader)

    def one_batch():
        batch = next(stream)
        with torch.no_grad():
            cm = eval_step(net, common.to_device(batch, dev))
        return batch, cm

    try:
        one_batch()
        clock.sync()
        run.setup_s = time.perf_counter() - t0
        start = clock.mark()
        t_host = time.perf_counter()
        ends, seen = [], []
        while True:
            batch, cm = one_batch()
            ends.append(clock.mark())
            seen.append((batch["index"].tolist(), cm))
            run.window_images += int((batch["index"] >= 0).sum())
            if time.perf_counter() - t_host >= run.seconds:
                break
        clock.sync()
        run.unit_ends_ms = clock.ms(start, ends)
        run.window_ms = run.unit_ends_ms[-1]
        run.attempted = len(seen)
        run.failed = sum(1 for idx, cm in seen if int(cm.sum()) != val.valid_pixels(idx))
        if clock.cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated()
        if run.traced:
            run.trace = _profile(one_batch, traffic["trace_steps"], clock)
    finally:
        loader.close()
    picked = random.Random(run.seed).sample(range(len(seen)),
                                            min(traffic["check_batches"], len(seen)))
    sample = [(seen[i][0], seen[i][1].cpu()) for i in picked]
    del state, model, net, stream, seen, eval_step
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref, ties = reference_confusions(cell, weights, val, [idx for idx, _ in sample], dev)
    run.notes["reference_s"] = time.perf_counter() - t_ref
    valid = sum(val.valid_pixels(idx) for idx, _ in sample)
    readings = checks.eval_numbers([cm for _, cm in sample], ref, valid, ties)
    run.checks = checks.held(readings, cell.limits)
    run.notes["readings"] = readings


def _profile(one_batch, batches: int, clock: Clock) -> Trace:
    clock.sync()
    prof = torch.profiler.profile(activities=[profiler_activity(clock)])
    images = 0
    prof.start()
    t0 = time.perf_counter()
    for _ in range(batches):
        batch, _ = one_batch()
        images += int((batch["index"] >= 0).sum())
    clock.sync()
    wall = time.perf_counter() - t0
    prof.stop()
    return Trace.from_profiler(prof, wall, batches, images)


def reference_confusions(cell, state: Dict, val, batches, device, rounding: str = "f32"):
    """The plain reference's confusion matrix of each val batch (a list of
    dataset indices) with the weights ``state``, as CPU tensors, and the
    batches' near-tie share (``evaluate.near_tie_share`` at the traffic's
    ``near_tie``), pixel-weighted."""
    reference_backends()
    cfgd = cell.config["config"]
    d = cfgd["data"]
    model = build(cfgd["model"], d["num_classes"], ROUNDINGS[rounding]).to(device)
    model.load_state_dict(state)
    out, ties = [], 0.0
    for idx in batches:
        b: Dict = to_device(val.assemble(idx), device)
        probs = evaluate.probabilities(model, b["image"], cfgd)
        ties += evaluate.near_tie_share(probs, b["label"], cfgd,
                                        cell.traffic["near_tie"]) * val.valid_pixels(idx)
        out.append(evaluate.confusion(probs.argmax(dim=1), b["label"], d["num_classes"],
                                      d["ignore_index"]).cpu())
    return out, ties / max(sum(val.valid_pixels(idx) for idx in batches), 1)
