#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases; any failure exits non-zero and prints no result:
 1. build    -- compile ``csrc/*.cu`` with nvcc for sm_90a (one nvcc per
                source, started together) and print the seconds;
 2. kernels  -- at config 3's shapes, each hand-written kernel against its
                plain PyTorch version on the same inputs, with its time, the
                plain version's, the library call's where one exists, and
                its bound on this card;
 3. reference -- at a small size, the stem segment (forward, backward)
                and one FixMatch step on the card (kernels) against the
                CPU (plain versions), from the same weights and inputs;
 4. slice    -- the port's ``Trainer`` trains config 3 (synthetic data,
                8 + 8 images at 512^2, ``model.stem_impl=pallas``,
                ``data.cutmix_impl=pallas``) for a few steps: losses finite,
                every kernel's launch counter advancing each step.
Then it prints the card's name and power limit, one JSON line of kernel
records, and the ok line.  A longer report goes to
``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG3 = os.path.join(REPO, "configs", "3_fixmatch_dlv3p_r50_voc_512.yaml")
OUT_DIR = os.path.join(REPO, "chiprun_out")

# Published dense peaks (NVIDIA data sheets): (name substring, bytes/s, bf16 FLOP/s,
# f32 non-tensor FLOP/s).  First match wins; H100 SXM is the default.
PEAKS = [
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100", 3.35e12, 989e12, 67e12),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        from semi_supervised_semantic_segmentation_tpu_torch.ops import (
            augment, cuda_build, stem)
        from semi_supervised_semantic_segmentation_tpu_torch.ops import (
            cutmix_normalize as cmn)
    except ImportError as e:
        fail(f"the port package is not next to chip_smoke.py: {e}")

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {smi_line}", flush=True)
    bw, bf16_peak, f32_peak = next((p[1:] for p in PEAKS if p[0] in name), PEAKS[-1][1:])
    print(f"peaks used for bounds: {bw / 1e12} TB/s, {bf16_peak / 1e12} TFLOP/s bf16, "
          f"{f32_peak / 1e12} TFLOP/s f32", flush=True)

    # f32 convs and matmuls in full precision (the plain versions and the
    # blur/resize of the step compute in f32 like the reference's HIGHEST).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    report = {"card": smi_line, "device": name}

    # ------------------------------------------------------------- 1. build
    t0 = time.time()
    built = cuda_build.build_all(["stem.cu"], extra=["-Xptxas", "-v"])
    build_s = time.time() - t0
    print(f"[build] nvcc {', '.join(built)}: {build_s:.1f} s", flush=True)
    report["build"] = {k: {"seconds": v["seconds"], "log": v["log"]} for k, v in built.items()}
    for line in built["stem.cu"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def time_ms(fn, reps: int = 10) -> float:
        """Median of ``reps`` single calls, each after an L2 flush."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def bound(nbytes: float, flops: float, peak: float):
        tb, tf = nbytes / bw * 1e3, flops / peak * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    kernels = {}
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    # ------------------------------------------------- 2. kernels: B, C, A
    n, h, w_ = 16, 512, 512
    h2, w2 = h // 2, w_ // 2
    x = (torch.rand(n, h, w_, 3, generator=g, device=dev) * 4.0 - 2.0).to(bf16)
    wt = torch.randn(64, 3, 7, 7, generator=g, device=dev) * 0.05
    w_hwio = wt.permute(2, 3, 1, 0).contiguous()
    yk, sk = stem.stem_fwd_cuda(x, w_hwio)
    torch.cuda.synchronize()
    yp, sp = stem.stem_fwd_plain(x, wt)
    err_y = (yk.float() - yp.float()).abs()
    # about one bf16 ulp (2^-8 relative, rounding either way) plus f32
    # summation-order noise near zero
    check(bool((err_y <= 2.0 ** -7 * yp.float().abs() + 1e-4).all()),
          f"B: y differs from the plain version by {err_y.max().item()}")
    err_s = (sk - sp).abs()
    check(bool((err_s <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all()),
          f"B: stats differ by {err_s.max().item()} (rtol 1e-3 of each row's max)")
    x_nchw = x.permute(0, 3, 1, 2)
    w_bf = wt.to(bf16)
    k_b = {
        "ms": time_ms(lambda: stem.stem_fwd_cuda(x, w_hwio)),
        "plain_ms": time_ms(lambda: stem.stem_fwd_plain(x, wt)),
        # the conv alone: F.conv2d does not compute the BN statistics
        "library_ms": time_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_bf, stride=2, padding=3)),
    }
    nbytes = x.numel() * 2 + wt.numel() * 4 + yk.numel() * 2 + sk.numel() * 4
    flops = 2.0 * n * h2 * w2 * 147 * 64
    k_b["bound_ms"], k_b["bound_by"] = bound(nbytes, flops, bf16_peak)
    k_b["max_abs_err"] = err_y.max().item()
    kernels["stem_fwd"] = k_b
    print(f"[kernel B stem_fwd] N={n} {h}x{w_}: max|dy|={k_b['max_abs_err']:.3g} "
          f"max|dstats|={err_s.max().item():.3g}  kernel {k_b['ms']:.3f} ms  plain "
          f"{k_b['plain_ms']:.3f} ms  F.conv2d {k_b['library_ms']:.3f} ms  bound "
          f"{k_b['bound_ms']:.4f} ms ({k_b['bound_by']})", flush=True)

    dy = (torch.randn(n, 64, h2, w2, generator=g, device=dev) * 1e-2).to(bf16)
    ds = torch.randn(2, 64, generator=g, device=dev) * 1e-3
    dwk = stem.stem_dw_cuda(x, dy, yk, ds, 7)
    torch.cuda.synchronize()
    dwp = stem.stem_dw_plain(x, dy, yk, ds, 7).permute(2, 3, 1, 0)
    err_w = (dwk - dwp).abs().max().item()
    check(err_w <= 1e-3 * dwp.abs().max().item(),
          f"C: dW differs by {err_w} (tolerance 1e-3 of max|dW|={dwp.abs().max().item()})")
    dY_bf = stem.fold_stats_cotangent(dy, yk, ds)
    k_c = {
        "ms": time_ms(lambda: stem.stem_dw_cuda(x, dy, yk, ds, 7)),
        "plain_ms": time_ms(lambda: stem.stem_dw_plain(x, dy, yk, ds, 7)),
        # the weight gradient alone: the stats fold is not part of the call
        "library_ms": time_ms(lambda: torch.nn.grad.conv2d_weight(
            x_nchw, (64, 3, 7, 7), dY_bf, stride=2, padding=3)),
    }
    nbytes = x.numel() * 2 + dy.numel() * 2 + yk.numel() * 2 + ds.numel() * 4 + dwk.numel() * 4
    k_c["bound_ms"], k_c["bound_by"] = bound(nbytes, flops, bf16_peak)
    k_c["max_abs_err"] = err_w
    kernels["stem_dw"] = k_c
    print(f"[kernel C stem_dw] max|ddW|={err_w:.3g} (max|dW| {dwp.abs().max().item():.3g})  "
          f"kernel {k_c['ms']:.3f} ms  plain {k_c['plain_ms']:.3f} ms  conv2d_weight "
          f"{k_c['library_ms']:.3f} ms  bound {k_c['bound_ms']:.4f} ms ({k_c['bound_by']})",
          flush=True)
    del x, yk, yp, dy, dwk, dwp, dY_bf, x_nchw

    b = 8
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    imgs = torch.rand(b, h, w_, 3, generator=g, device=dev)
    labs = torch.randint(0, 21, (b, h, w_), generator=g, device=dev, dtype=torch.int32)
    conf = torch.rand(b, h, w_, generator=g, device=dev) > 0.5
    u = torch.rand(b, 4, generator=g, device=dev)
    boxes = augment.cutmix_boxes(u, h, w_, 1.0)
    check(torch.equal(boxes.cpu(), augment.cutmix_boxes(u.cpu(), h, w_, 1.0)),
          "A: boxes computed on the card differ from the host's")
    t0 = time.time()
    oi, ol, oc = cmn.cutmix_normalize_triton(imgs, labs, conf, boxes, mean, std, bf16)
    torch.cuda.synchronize()
    triton_s = time.time() - t0
    pi, pl, pc = cmn.cutmix_normalize_plain(imgs, labs, conf, boxes, mean, std, bf16)
    err_i = (oi.float() - pi.float()).abs()
    check(bool((err_i <= 2.0 ** -7 * pi.float().abs() + 1e-6).all()),
          f"A: image differs by {err_i.max().item()} (about one bf16 ulp allowed)")
    check(torch.equal(ol, pl) and torch.equal(oc, pc), "A: labels or conf differ")
    k_a = {
        "ms": time_ms(lambda: cmn.cutmix_normalize_triton(imgs, labs, conf, boxes, mean, std, bf16)),
        "plain_ms": time_ms(lambda: cmn.cutmix_normalize_plain(imgs, labs, conf, boxes, mean, std, bf16)),
        "library_ms": None,
    }
    nbytes = imgs.numel() * 4 + labs.numel() * 4 + conf.numel() + boxes.numel() * 4 \
        + oi.numel() * 2 + ol.numel() * 4 + oc.numel()
    k_a["bound_ms"], k_a["bound_by"] = bound(nbytes, 2.0 * imgs.numel(), f32_peak)
    k_a["max_abs_err"] = err_i.max().item()
    kernels["cutmix_normalize"] = k_a
    print(f"[kernel A cutmix_normalize] B={b} {h}x{w_}: triton compile+first launch "
          f"{triton_s:.1f} s  max|dimg|={k_a['max_abs_err']:.3g} labels/conf exact  kernel "
          f"{k_a['ms']:.3f} ms  plain {k_a['plain_ms']:.3f} ms  bound {k_a['bound_ms']:.4f} ms "
          f"({k_a['bound_by']})", flush=True)
    del imgs, labs, conf, oi, ol, oc, pi, pl, pc
    report["triton_first_launch_s"] = triton_s

    # -------------------------------------------- 3. reference, small size
    report["reference"] = reference_phase(torch, dev)

    # ------------------------------------------------------- 4. the slice
    slice_report, launches = slice_phase(torch, dev)
    report["slice"] = slice_report

    meta = {
        "cutmix_normalize": ("triton", "semi_supervised_semantic_segmentation_tpu_torch/ops/cutmix_normalize.py",
                             "semi_supervised_semantic_segmentation_tpu/ops/pallas_aug.py:97"),
        "stem_fwd": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/stem.cu",
                     "semi_supervised_semantic_segmentation_tpu/ops/pallas_stem.py:206"),
        "stem_dw": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/stem.cu",
                    "semi_supervised_semantic_segmentation_tpu/ops/pallas_stem.py:235"),
    }
    records = []
    for kname, (route, source, replaces) in meta.items():
        k = kernels[kname]
        records.append({
            "name": kname, "route": route, "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    report["kernels"] = records
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(f"card: {smi_line}", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def _to(obj, dev):
    """Move the tensors of a (possibly nested) draws dataclass to ``dev``."""
    import torch

    if torch.is_tensor(obj):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj)})
    return obj


def reference_phase(torch, dev) -> dict:
    """The kernels inside the model against the plain path on the CPU, at a
    small size, from the same weights and inputs:

    (a) the stem segment (kernel B, BatchNorm folded from the kernel's own
        sums, ReLU, max-pool) forward and backward in train mode, N=2 at
        128^2: pooled, c1, the running statistics and dW, whose backward
        goes through kernel C with the statistics' cotangent ds != 0;
    (b) one FixMatch step at crop 64 (2 + 2 images, bf16) on the card
        (kernels A, B and C) and on the CPU (plain versions): the step's
        losses, which are computed before its update.

    Only the first step is compared: a randomly initialised R50 at crop 64
    is numerically chaotic (tests/test_torch_fixmatch.py), so later steps
    of two backends part for reasons that are not the kernels'."""
    import numpy as np

    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config
    from semi_supervised_semantic_segmentation_tpu_torch.methods import common, fixmatch
    from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
    from semi_supervised_semantic_segmentation_tpu_torch.models.layers import StemSegment

    out = {}
    # ---- (a) stem segment
    g = torch.Generator().manual_seed(3)
    x = (torch.rand(2, 128, 128, 3, generator=g) * 4.0 - 2.0).to(torch.bfloat16)
    r_pool = torch.randn(2, 64, 32, 32, generator=g)
    r_c1 = torch.randn(2, 64, 64, 64, generator=g)
    seg0 = StemSegment(impl="pallas")
    with torch.no_grad():
        seg0.Conv_0.weight.normal_(0.0, 0.1, generator=g)
        seg0.Norm_0.BatchNorm_0.weight.uniform_(0.5, 1.5, generator=g)
        seg0.Norm_0.BatchNorm_0.bias.normal_(0.0, 0.1, generator=g)
    res = {}
    for where in (dev, "cpu"):
        seg = copy.deepcopy(seg0).to(where).train()
        pooled, c1 = seg(x.to(where))
        loss = (pooled.float() * r_pool.to(where)).sum() + (c1.float() * r_c1.to(where)).sum()
        loss.backward()
        bn = seg.Norm_0.BatchNorm_0
        res[str(where)] = [t.detach().float().cpu() for t in
                           (pooled, c1, bn.running_mean, bn.running_var, seg.Conv_0.weight.grad)]
    card, cpu = res[str(dev)], res["cpu"]
    for name, a, b in zip(("pooled", "c1"), card, cpu):
        # two bf16 roundings of the same value (y, then the BN output) can
        # differ by one ulp each: 2^-7 relative, plus the f32 fold's noise
        err = (a - b).abs()
        check(bool((err <= 2.0 ** -6 * b.abs() + 1e-2).all()),
              f"reference: stem segment {name} differs by {err.max().item()}")
    for name, a, b in zip(("running_mean", "running_var"), card[2:4], cpu[2:4]):
        check(torch.allclose(a, b, rtol=1e-3, atol=1e-5),
              f"reference: stem segment {name} differs by {(a - b).abs().max().item()}")
    dw_err = (card[4] - cpu[4]).abs().max().item()
    dw_max = cpu[4].abs().max().item()
    # one-ulp differences of y move BN-output roundings and, rarely, a
    # max-pool's winner; summed over 8192 pixels per tap they stay small
    check(dw_err <= 2e-2 * dw_max,
          f"reference: stem segment dW differs by {dw_err} (tolerance 2e-2 of {dw_max})")
    print(f"[reference] stem segment N=2 128^2 train: max|d pooled|="
          f"{(card[0] - cpu[0]).abs().max().item():.3g} max|d c1|={(card[1] - cpu[1]).abs().max().item():.3g} "
          f"max|d dW|={dw_err:.3g} of max|dW| {dw_max:.3g} (tolerance 2e-2)", flush=True)
    out["stem_segment"] = {"dw_err": dw_err, "dw_max": dw_max}

    # ---- (b) one FixMatch step
    crop = 64
    cfg = load_config(CONFIG3, {
        "data.dataset": "synthetic", "data.crop_size": crop, "model.stem_impl": "pallas",
        "data.cutmix_impl": "pallas", "train.labeled_batch_size": 2,
        "train.unlabeled_batch_size": 2, "method.conf_thresh": 0.0,
    })
    rng = np.random.RandomState(0)

    def batch(labeled: bool):
        img = (rng.rand(2, crop, crop, 3) * 255).astype(np.uint8)
        lab = (rng.randint(0, 21, (2, crop, crop)) if labeled
               else np.full((2, crop, crop), 255)).astype(np.int32)
        return {"image": img, "label": lab, "size": np.full((2, 2), crop, np.int32)}

    bl, bu = batch(True), batch(False)
    draws = fixmatch.draw(cfg, common.to_device(bl, "cpu"), common.to_device(bu, "cpu"),
                          common.step_generator(1, 0, "cpu"))
    draws.dropout = torch.rand(4, 256, crop // 16, crop // 16,
                               generator=torch.Generator().manual_seed(0)) < 0.5
    step_fn = fixmatch.make_train_step(cfg, 10)
    runs = {}
    for where in (dev, "cpu"):
        state = fixmatch.init_state(cfg, build_model(cfg, seed=0).to(where), 10)
        m = step_fn(state, common.to_device(bl, where), common.to_device(bu, where),
                    _to(draws, where))
        runs[str(where)] = np.array([float(m[k]) for k in ("loss", "sup_loss", "unsup_loss")])
    lg, lc = runs[str(dev)], runs["cpu"]
    check(bool(np.all(np.isfinite(lg))), f"reference: non-finite losses on the card {lg}")
    rel = np.abs(lg - lc) / np.maximum(np.abs(lc), 1e-3)
    check(float(rel.max()) < 5e-2, f"reference: losses card {lg.tolist()} vs cpu {lc.tolist()}")
    print(f"[reference] FixMatch step, crop {crop}, 2+2 bf16: (loss, sup, unsup) card "
          f"{lg.tolist()} cpu {lc.tolist()} max rel {rel.max():.3g} (tolerance 5e-2: bf16 "
          f"convolutions of two backends through 60 layers)", flush=True)
    out["fixmatch_step"] = {"losses_card": lg.tolist(), "losses_cpu": lc.tolist()}
    return out


def slice_phase(torch, dev):
    """Config 3 through the Trainer: 8 + 8 images at 512^2 for a few steps.
    Steps 3-6 are timed; the last two run under torch.profiler for the
    breakdown of device time by kernel."""
    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer
    from semi_supervised_semantic_segmentation_tpu_torch.ops import cutmix_normalize as cmn
    from semi_supervised_semantic_segmentation_tpu_torch.ops import stem

    steps, warm, profiled = 8, 2, 2
    cfg = load_config(CONFIG3, {
        "data.dataset": "synthetic", "data.synthetic_canvas": 512, "data.synthetic_size": 48,
        "data.cutmix_impl": "pallas", "model.stem_impl": "pallas", "data.num_workers": 8,
        "train.iters_per_epoch": steps, "train.epochs": 1, "train.log_interval": 1,
        "train.work_dir": os.path.join(OUT_DIR, "chip_smoke_run"),
    })
    counters = {"cutmix_normalize": cmn.cutmix_normalize_triton,
                "stem_fwd": stem.stem_fwd_cuda, "stem_dw": stem.stem_dw_cuda}
    expected = {"cutmix_normalize": 1, "stem_fwd": 2, "stem_dw": 1}
    trainer = Trainer(cfg)  # default device: CUDA
    inner = trainer.train_step
    per_step, losses, times = [], [], []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    window = []

    def counted(state, lab, unlab):
        before = {k: f.launches for k, f in counters.items()}
        if len(times) == steps - profiled:
            prof.start()
            window.append(time.time())
        t0 = time.time()
        metrics = inner(state, lab, unlab)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        per_step.append({k: f.launches - before[k] for k, f in counters.items()})
        losses.append(float(metrics["loss"]))
        if len(times) == steps:
            window.append(time.time())
            prof.stop()
        return metrics

    trainer.train_step = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    trainer.fit()
    launches = {k: f.launches for k, f in counters.items()}
    check(len(losses) == steps, f"slice: ran {len(losses)} steps, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"slice: non-finite loss {losses}")
    for i, d in enumerate(per_step):
        check(d == expected, f"slice: step {i} launched {d}, expected {expected}")
    check(all(launches[k] == steps * expected[k] for k in expected), f"slice: launches {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = times[warm:steps - profiled]
    ms = statistics.median(timed) * 1e3
    imgs = cfg.train.labeled_batch_size + cfg.train.unlabeled_batch_size
    print(f"[slice] config 3 synthetic, {cfg.train.labeled_batch_size}+"
          f"{cfg.train.unlabeled_batch_size} at {cfg.data.crop_size}^2, {steps} steps: losses "
          f"{[round(v, 4) for v in losses]}; launches per step {per_step[-1]}; "
          f"{ms:.1f} ms/step (median of steps {warm + 1}-{steps - profiled}) = {imgs / ms * 1e3:.1f} img/s; "
          f"peak memory {peak_gb:.2f} GB; step times s {[round(t, 3) for t in times]}", flush=True)
    breakdown = device_breakdown(torch, prof, (window[1] - window[0]) * 1e3, profiled)
    return ({"losses": losses, "step_s": times, "ms_per_step": ms,
             "img_per_s": imgs / ms * 1e3, "peak_gb": peak_gb, "per_step_launches": per_step,
             "profile": breakdown}, launches)


# lower-cased kernel-name fragments -> group, first match wins
GROUPS = [
    ("stem kernels (B, C)", ("stem_fwd_kernel", "stem_dw_kernel", "reduce_partials_kernel")),
    ("cutmix kernel (A)", ("_cutmix_normalize_kernel",)),
    ("cuDNN layout transforms", ("nchwtonhwc", "nhwctonchw")),
    ("conv / GEMM (cuDNN, cuBLAS)", ("cudnn", "conv", "xmma", "gemm", "cutlass", "sm90",
                                      "wgrad", "dgrad", "winograd")),
    ("batch norm", ("batch_norm", "batchnorm")),
    ("bilinear resize", ("upsample",)),
    ("memcpy / memset", ("memcpy", "memset")),
    ("reductions", ("reduce",)),
]


def device_breakdown(torch, prof, wall_ms: float, nsteps: int) -> dict:
    """Device time per step by kernel group and the top kernels, from the
    profiled window; busy share = summed kernel time / window wall time."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in evs)
    if total_us <= 0:
        print("[profile] the profiler saw no device time", flush=True)
        return {"device_ms_per_step": None}
    groups = {}
    for e in evs:
        low = e.key.lower()
        g = next((name for name, frags in GROUPS if any(f in low for f in frags)),
                 "other elementwise / indexing")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / nsteps
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:12]
    dev_ms = total_us / 1e3 / nsteps
    out = {"device_ms_per_step": dev_ms, "wall_ms_per_step": wall_ms / nsteps,
           "busy_share": total_us / 1e3 / wall_ms,
           "groups_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "top": [{"kernel": e.key[:120], "ms_per_step": e.self_device_time_total / 1e3 / nsteps,
                    "calls_per_step": e.count / nsteps} for e in top]}
    print(f"[profile] {nsteps} profiled steps: device {dev_ms:.1f} ms/step of "
          f"{wall_ms / nsteps:.1f} ms wall (busy {out['busy_share']:.3f}); by group ms/step "
          f"{ {k: round(v, 2) for k, v in out['groups_ms_per_step'].items()} }", flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['ms_per_step']:8.3f} ms/step  x{t['calls_per_step']:.0f}  "
              f"{t['kernel']}", flush=True)
    return out


if __name__ == "__main__":
    main()
