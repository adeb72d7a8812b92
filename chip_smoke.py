#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                 (from the repository root; needs one CUDA card)
    python3 chip_smoke.py --kernels-only  (phases 1 and 2 for kernels B, C, D and E
                                           only: their checks and times, no ok line)

Phases; any failure exits non-zero and prints no result:
 1. build    -- compile ``csrc/*.cu`` with nvcc for sm_90a (one nvcc per
                source, started together) and print the seconds;
 2. kernels  -- each hand-written kernel against its plain PyTorch version
                on the same inputs, at the shapes its path gives it (A at
                config 3's; B at config 3's two batches [8|16,512^2], config
                1's [8,128^2], config 2's [8|16,256^2], config 4's [8,768^2]
                and its eval's [16,768^2], [64,768^2] and [144,768^2], C at
                [16,512^2], [8,128^2], [16,256^2] and [8,768^2], each twice
                on the same inputs,
                bit-equal, with their tile plan and registers; D, D's post
                mode and E at config 5's two
                eligible HRNet branches, [8,48,256,256] and [8,96,128,128]),
                with its time, the plain version's, the library call's where
                one exists, and its bound on this card; at C = 96 D96 and
                at C = 48 D48 (D's kernels for those widths), each with its
                plan and registers, bit-equal over two launches and to
                conv_fwd_kernel (a misaligned input; [2,C] sums within f32
                reordering), which is timed beside it, in every mode; D's
                post mode also
                bit-equal to D's dx conv followed by ``pre_backward`` on the
                card, twice on the same inputs, with the times of
                ``pre_backward`` alone and of that unfused chain; E also twice
                on the same inputs and through its synchronous fill (a
                misaligned input) beside its asynchronous ring, all
                bit-equal, with its tile plan and the registers ptxas gives it;
 2b. D at eval -- D in ``pre`` mode at every shape config 5's shipped eval
                gives it (each scale's windows of both views in one
                batch: branch 0 at C = 48, branch 1 at C = 96), against its
                plain version, with the kernel ``fwd_kernel`` picks, its
                time, the plain version's, ``F.conv2d``'s and its bound;
 3. reference -- at a small size, on the card (kernels) against the CPU
                (plain versions), from the same weights and inputs: the stem
                segment and one config-3 FixMatch step; an HRModule (branches
                16/32) forward and backward (D's post mode in the
                backward); one config-5 FixMatch step (OHEM, fused branch
                convs, remat 'stages:3') on a width-8 HRNet; the eval of a
                width-8 HRNet through the staged path (sliding, flip, two
                scales: D on the card) and of config 3's R50 at 256^2 with
                ``stem_impl=pallas`` (B on the card): probability sums and
                confusion matrices; one supervised step (config 1), one
                Mean-Teacher step (config 2) and one CPS step (config 4's
                method) in each form, 'separate' and 'stacked'
                (torch.func.vmap), on U-Net/R18 at 128^2 (B and C on the
                card): losses and the update as one vector, held to fixed
                limits (STEP_REF_LIMITS), and the card's stacked step to its
                separate one;
 4. slice    -- the port's ``Trainer`` trains config 3 (synthetic data,
                8 + 8 images at 512^2, ``model.stem_impl=pallas``,
                ``data.cutmix_impl=pallas``) and then config 5 as shipped
                (synthetic data, 4 + 4 images at 1024^2, HRNet-W48 + HRNetV2
                head, ``branch_conv=pallas``, remat 'stages:3', OHEM) for a
                few steps each: losses finite, each path's kernels launched
                the derived number of times at every step (E on its
                asynchronous ring every time; config 5's C = 96 branch convs
                on D96 and its C = 48 ones on D48, post mode included, and
                none on conv_fwd_kernel), time per step,
                peak memory and a profile.  Each run ends in ``Trainer.fit``'s
                evaluation (``train.epochs=1``), counted and measured apart
                from training: the ``val`` record, wall seconds, val
                images/s, peak memory, device time by kernel group and each
                kernel's launches per val pass against the derived counts
                (config 3: B twice per val batch; config 5 as shipped: D
                128 times per forward, one forward per scale).  Config 3's
                trained state then goes through a reference-layout
                checkpoint file into a fresh model through the eval entry
                point's loader: the same confusion matrix.  Then config 1
                (supervised U-Net/R18, 8 images at 128^2, B and C once a
                step; ``train.profile_steps=2``: the trainer's own trace of
                steps 2-4, its path, size and per-step summary) and config
                2 (Mean Teacher, 8 + 8 at 256^2, B twice a step and C once),
                both ``model.stem_impl=pallas`` on synthetic data, counted
                and measured as above; config 2's rolling slot is then
                restored by a second Trainer (``train.resume=auto``,
                ``train.epochs=2``) bit-equal, which trains epoch 1, and the
                eval entry point's loader reads the ``checkpoints``
                directory: the trained state's confusion matrix.  Then
                config 4 (CPS, DeepLabV3+/ResNet-101, 4 + 4 at 768^2 from
                1024^2 canvases, OHEM, 'separate' as shipped, B and C once
                per net per step; eval staged: sliding 768 / 512, flip, six
                scales, B once per scale), its rolling slot resumed on the
                card as config 2's, and 4 steps of the 'stacked' form (B and
                C once per net, its step 0 against the separate run's) with
                their device time.
Then it prints the card's name and power limit, one JSON line of kernel
records (launches in the training runs, per val pass and per step of each
config), and the ok line.  A longer report goes to
``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG1 = os.path.join(REPO, "configs", "1_supervised_unet_r18_128.yaml")
CONFIG2 = os.path.join(REPO, "configs", "2_mean_teacher_unet_voc_256.yaml")
CONFIG3 = os.path.join(REPO, "configs", "3_fixmatch_dlv3p_r50_voc_512.yaml")
CONFIG4 = os.path.join(REPO, "configs", "4_cps_dlv3p_r101_cityscapes_768.yaml")
CONFIG5 = os.path.join(REPO, "configs", "5_hrnet_w48_1024_full_ssl.yaml")
OUT_DIR = os.path.join(REPO, "chiprun_out")

# Published dense peaks (NVIDIA data sheets): (name substring, bytes/s, bf16 FLOP/s,
# f32 non-tensor FLOP/s).  First match wins; H100 SXM is the default.
PEAKS = [
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H200", 4.8e12, 989e12, 67e12),
    ("H100", 3.35e12, 989e12, 67e12),
]


# Failed checks; the script runs every phase, then exits non-zero before
# printing any result if this is not empty.
FAILURES = []


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke: CHECK FAILED: {msg}", file=sys.stderr, flush=True)
        FAILURES.append(msg)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        from semi_supervised_semantic_segmentation_tpu_torch.ops import (
            augment, branch_conv, cuda_build, stem)
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
    built = cuda_build.build_all(["stem.cu", "branch_conv.cu"], extra=["-Xptxas", "-v"])
    build_s = time.time() - t0
    print(f"[build] nvcc {', '.join(built)} in parallel: {build_s:.1f} s", flush=True)
    report["build"] = {k: {"seconds": v["seconds"], "log": v["log"]} for k, v in built.items()}
    for src, b in built.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src} ptxas: {line.strip()}", flush=True)
    report["ptxas"] = ptxas = {**ptxas_usage(built["stem.cu"]["log"]),
                               **ptxas_usage(built["branch_conv.cu"]["log"])}

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    kernels_only = "--kernels-only" in sys.argv[1:]

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
    if kernels_only:
        report["stem_kernels"] = stem_kernels(torch, dev, stem, time_ms, bound, bf16_peak, ptxas)
        rows = branch_kernels(torch, dev, branch_conv, time_ms, bound, bf16_peak, ptxas)
        report["branch_kernels"] = dict(zip(("D", "E", "E_plan", "D_plan"), rows))
        report["failures"] = FAILURES
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"card: {smi_line}", flush=True)
        sys.exit(1 if FAILURES else 0)

    # ------------------------------------------------- 2. kernels: B, C, A
    h, w_ = 512, 512
    report["stem_kernels"] = stem_rows = stem_kernels(torch, dev, stem, time_ms, bound,
                                                      bf16_peak, ptxas)
    kernels["stem_fwd"] = stem_rows["B N16 512^2"]
    kernels["stem_dw"] = stem_rows["C N16 512^2"]

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

    # ------------------------------------------ 2. kernels: D, E (config 5)
    d_rows, e_rows, e_plans, d_plans = branch_kernels(torch, dev, branch_conv, time_ms, bound,
                                                      bf16_peak, ptxas)
    report["branch_kernels"] = {"D": d_rows, "E": e_rows, "E_plan": e_plans, "D_plan": d_plans}
    # the records of the line: the modes the path runs most, D48 at branch
    # 0's shape, D96 at branch 1's (conv_fwd_kernel, which the path no
    # longer launches, is timed in their rows as "old_kernel_ms")
    kernels["branch_conv_fwd_c48"] = d_rows["N8_C48_256x256 pre+stats"]
    kernels["branch_conv_dx_post_c48"] = d_rows["N8_C48_256x256 post"]
    kernels["branch_conv_fwd_c96"] = d_rows["N8_C96_128x128 pre+stats"]
    kernels["branch_conv_dx_post_c96"] = d_rows["N8_C96_128x128 post"]
    kernels["branch_conv_dw"] = e_rows["N8_C48_256x256 fuse+pre"]

    # ------------------------------------ 2b. D at config 5's eval shapes
    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config

    slice5 = {"data.synthetic_canvas": 1024, "data.synthetic_size": 8,
              "train.labeled_batch_size": 4, "train.unlabeled_batch_size": 4}
    cfg5 = load_config(CONFIG5, {"data.dataset": "synthetic", **slice5})
    eval5_shapes = eval_branch_shapes(cfg5, branch_conv)
    report["d_eval_shapes"] = d_eval_rows(torch, dev, branch_conv, time_ms, bound, bf16_peak,
                                          eval5_shapes)

    # -------------------------------------------- 3. reference, small size
    report["reference"] = reference_phase(torch, dev)
    report["reference"]["eval"] = eval_reference_phase(torch, dev)
    report["reference"]["unet_steps"] = unet_step_reference(torch, dev)

    # ------------------------------------------------------ 4. the slices
    # name -> (wrapper, counter attribute); "branch_conv_dx_post" counts D's
    # post-mode launches (also in D's "launches"), "..._c96" / "..._c48"
    # those of them on D96 / D48, "branch_conv_dw_async" E's launches on its
    # asynchronous ring
    counters = {"cutmix_normalize": (cmn.cutmix_normalize_triton, "launches"),
                "stem_fwd": (stem.stem_fwd_cuda, "launches"),
                "stem_dw": (stem.stem_dw_cuda, "launches"),
                "branch_conv_fwd": (branch_conv.conv3x3_fwd_cuda, "launches"),
                "branch_conv_dx_post": (branch_conv.conv3x3_fwd_cuda, "launches_post"),
                "branch_conv_fwd_c96": (branch_conv.conv3x3_fwd_cuda, "launches_c96"),
                "branch_conv_dx_post_c96": (branch_conv.conv3x3_fwd_cuda, "launches_c96_post"),
                "branch_conv_fwd_c48": (branch_conv.conv3x3_fwd_cuda, "launches_c48"),
                "branch_conv_dx_post_c48": (branch_conv.conv3x3_fwd_cuda, "launches_c48_post"),
                "branch_conv_dw": (branch_conv.conv3x3_dw_cuda, "launches"),
                "branch_conv_dw_async": (branch_conv.conv3x3_dw_cuda, "launches_async")}
    none = {k: 0 for k in counters}
    # eval: config 3's 24 synthetic val images in 3 batches of 8, two
    # forwards each (the image and its mirror), one stem each: B 2 x 3
    report["slice_config3"], launches3, eval3 = slice_phase(torch, "config 3", CONFIG3, {
        "data.synthetic_canvas": 512, "data.synthetic_size": 48, "data.cutmix_impl": "pallas",
        "model.stem_impl": "pallas"}, counters,
        {**none, "cutmix_normalize": 1, "stem_fwd": 2, "stem_dw": 1}, steps=8,
        eval_expected={**none, "stem_fwd": 2 * 3}, after_fit=checkpoint_round_trip)
    # D: 8 modules x 2 eligible branches (48 and 96 ch) x 4 blocks x 2 convs
    # = 128 per forward: teacher 128 + student 128 + stage 3's 4 modules
    # re-run by the checkpoint (64) + the dx convs (128), of which the 64 of
    # the convs with the input transform (each block's second) run in D's
    # post mode; the half of each at C = 96 (branch 1, W = 128) on D96, the
    # other half at C = 48 (branch 0, W = 256) on D48; E: 128.
    # eval (8 val images, one batch, 6 scales, flip, sliding): each scale's
    # windows of both views in one forward, 128 D launches each, on the
    # kernel fwd_kernel picks for each eligible branch shape (phase 2b)
    report["slice_config5"], launches5, eval5 = slice_phase(torch, "config 5", CONFIG5, slice5,
        counters,
        {**none, "branch_conv_fwd": 448, "branch_conv_dx_post": 64, "branch_conv_fwd_c96": 224,
         "branch_conv_dx_post_c96": 32, "branch_conv_fwd_c48": 224, "branch_conv_dx_post_c48": 32,
         "branch_conv_dw": 128, "branch_conv_dw_async": 128},
        steps=8, eval_expected={**none, **eval_d_launches(eval5_shapes, branch_conv, cfg5)})
    old_eval = eval5["branch_conv_fwd"] - eval5["branch_conv_fwd_c96"] - eval5["branch_conv_fwd_c48"]
    print(f"[slice] config 5 eval: conv_fwd_kernel launched {old_eval} times per val pass "
          f"(D48 {eval5['branch_conv_fwd_c48']}, D96 {eval5['branch_conv_fwd_c96']})", flush=True)
    # conv_fwd_kernel's launches are D's less D96's and D48's: none
    old = launches5["branch_conv_fwd"] - launches5["branch_conv_fwd_c96"] \
        - launches5["branch_conv_fwd_c48"]
    check(old == 0, f"config 5: conv_fwd_kernel launched {old} times, expected none")
    # config 1 (supervised U-Net/R18, 8 images at 128^2): B and C once per
    # step; train.profile_steps=2 traces steps 2-4 (the slice's own profile
    # takes steps 6 and 7); eval: 32 synthetic val images, 4 batches, one
    # forward each
    cfg1_over = {"data.synthetic_canvas": 128, "model.stem_impl": "pallas",
                 "train.profile_steps": 2}
    cfg1 = load_config(CONFIG1, {"data.dataset": "synthetic", **cfg1_over})
    report["slice_config1"], launches1, eval1 = slice_phase(
        torch, "config 1", CONFIG1, cfg1_over, counters,
        {**none, "stem_fwd": 1, "stem_dw": 1}, steps=8,
        eval_expected={**none, "stem_fwd": val_stem_launches(cfg1)},
        after_fit=profile_trace_check)
    # config 2 (Mean Teacher U-Net/R18, 8 + 8 at 256^2; VOC is not in the
    # repo): B twice per step (teacher N = 8, student N = 16), C once (N =
    # 16); eval: 8 synthetic val images, one batch, one forward; a rolling
    # slot after the epoch, then the resume on the card
    cfg2_over = {"data.synthetic_canvas": 256, "data.synthetic_size": 16,
                 "model.stem_impl": "pallas", "train.checkpoint_interval": 1}
    cfg2 = load_config(CONFIG2, {"data.dataset": "synthetic", **cfg2_over})
    report["slice_config2"], launches2, eval2 = slice_phase(
        torch, "config 2", CONFIG2, cfg2_over, counters,
        {**none, "stem_fwd": 2, "stem_dw": 1}, steps=8,
        eval_expected={**none, "stem_fwd": val_stem_launches(cfg2)},
        after_fit=lambda t, tr, c: resume_on_card(t, tr, c, "config 2"))

    # config 4 (CPS, DeepLabV3+/R101 at 768^2, 4 + 4 from 1024^2 synthetic
    # canvases, OHEM, cps_impl 'separate' as shipped): B and C once per net
    # per step; eval: 8 val images in one batch, staged (sliding 768 / 512,
    # flip, six scales), one forward per scale, B 6; then the rolling slot
    # resumed on the card, and 4 steps of the 'stacked' form
    cfg4_over = {"data.synthetic_canvas": 1024, "data.synthetic_size": 16,
                 "train.labeled_batch_size": 4, "train.unlabeled_batch_size": 4,
                 "model.stem_impl": "pallas", "train.checkpoint_interval": 1}
    cfg4 = load_config(CONFIG4, {"data.dataset": "synthetic", **cfg4_over})
    stacked4 = {}
    report["slice_config4"], launches4, eval4 = slice_phase(
        torch, "config 4", CONFIG4, cfg4_over, counters, {**none, "stem_fwd": 2, "stem_dw": 2},
        steps=8, eval_expected={**none, "stem_fwd": staged_forwards(cfg4)},
        after_fit=lambda t, tr, c: {
            "resume": resume_on_card(t, tr, c, "config 4"),
            "stacked": stacked_steps(t, c, counters, {**none, "stem_fwd": 2, "stem_dw": 2},
                                     stacked4)})

    runs = {"config 1": (launches1, eval1, 8), "config 2": (launches2, eval2, 8),
            "config 3": (launches3, eval3, 8), "config 4": (launches4, eval4, 8),
            "config 4 stacked": (stacked4.get("launches", none), none, STACKED_STEPS),
            "config 5": (launches5, eval5, 8)}
    launches = {k: sum(r[0][k] for r in runs.values()) for k in counters}
    by_config = {k: {c: {"per_step": r[0][k] / r[2], "run": r[0][k], "per_val_pass": r[1][k]}
                     for c, r in runs.items() if r[0][k] or r[1][k]} for k in counters}

    meta = {
        "cutmix_normalize": ("triton", "semi_supervised_semantic_segmentation_tpu_torch/ops/cutmix_normalize.py",
                             "semi_supervised_semantic_segmentation_tpu/ops/pallas_aug.py:97"),
        "stem_fwd": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/stem.cu",
                     "semi_supervised_semantic_segmentation_tpu/ops/pallas_stem.py:206"),
        "stem_dw": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/stem.cu",
                    "semi_supervised_semantic_segmentation_tpu/ops/pallas_stem.py:235"),
        "branch_conv_fwd_c48": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/branch_conv.cu",
                                "semi_supervised_semantic_segmentation_tpu/ops/pallas_conv.py:328"),
        "branch_conv_dx_post_c48": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/branch_conv.cu",
                                    "semi_supervised_semantic_segmentation_tpu/ops/pallas_conv.py:223"),
        "branch_conv_fwd_c96": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/branch_conv.cu",
                                "semi_supervised_semantic_segmentation_tpu/ops/pallas_conv.py:328"),
        "branch_conv_dx_post_c96": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/branch_conv.cu",
                                    "semi_supervised_semantic_segmentation_tpu/ops/pallas_conv.py:223"),
        "branch_conv_dw": ("cuda", "semi_supervised_semantic_segmentation_tpu_torch/csrc/branch_conv.cu",
                           "semi_supervised_semantic_segmentation_tpu/ops/pallas_conv.py:536"),
    }
    records = []
    for kname, (route, source, replaces) in meta.items():
        k = kernels[kname]
        records.append({
            "name": kname, "route": route, "source": source, "replaces": replaces,
            "launches": launches[kname],
            "launches_per_val_pass": sum(r[1][kname] for r in runs.values()),
            "launches_by_config": by_config[kname],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
        if kname in ("stem_fwd", "stem_dw"):
            records[-1]["shapes"] = {key.split(" ", 1)[1]: {f: row[f] for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                for key, row in stem_rows.items() if key.startswith("BC"[kname == "stem_dw"])}
    report["kernels"] = records
    report["failures"] = FAILURES
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if FAILURES:
        fail(f"{len(FAILURES)} check(s) failed: {FAILURES}")

    print(f"card: {smi_line}", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def ptxas_usage(log: str) -> dict:
    """Kernel name (with its integer template argument, as
    "conv_dw_kernel<6>") -> "N registers, M static shared bytes, S bytes
    spilled", from the ``-Xptxas -v`` log of one source (dynamic shared
    memory is the kernels' plans')."""
    out, cur, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'_Z(\d+)", line)
            cur = None
            if m:
                rest = line[m.end():]
                cur = rest[:int(m.group(1))]
                t = re.match(r"ILi(\d+)E", rest[int(m.group(1)):])
                if t:
                    cur += f"<{t.group(1)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur] = (f"{m.group(1)} registers, {sm.group(1) if sm else 0} static shared bytes, "
                        f"{spill} bytes spilled")
    return out


# (N, H = W) of kernel B's launches and whether C runs there too: config 3
# (512^2: teacher N = 8, student N = 16), config 1 (128^2, N = 8),
# config 2 (256^2: teacher N = 8, student N = 16) and config 4 (768^2: each
# net N = 8, B and C; its eval's windows of both views per scale, N = 16 at
# 512^2 and 768^2, 64 and 144 at 768^2); C runs at the student's
STEM_SHAPES = [(8, 512, False), (16, 512, True), (8, 128, True), (8, 256, False),
               (16, 256, True), (8, 768, True), (16, 768, False), (64, 768, False),
               (144, 768, False)]


def stem_kernels(torch, dev, stem, time_ms, bound, bf16_peak, ptxas) -> dict:
    """Kernels B and C (k = 7) at every shape of :data:`STEM_SHAPES`.  Each
    against its plain version on the same inputs (y within one bf16 ulp, the
    statistics within 1e-3 of each row's max, dW within 1e-3 of max|dW|),
    twice on the same inputs (bit-equal), with its time, the plain
    version's, the library call's and its bound; the tile plan and the
    registers ptxas gives each kernel.  Rows are keyed "B N<n> <h>^2"."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    plan = stem.stem_plan(7)
    plan["ptxas"] = {kn: ptxas.get(f"{kn}<7>", "not in the log")
                     for kn in ("stem_fwd_kernel", "stem_dw_kernel")}
    print(f"[stem plan k=7] {plan['threads']} threads, {plan['stages']} ring stages; B tiles "
          f"{plan['fwd_tile_rows']} x {plan['tile_pixels']} pixels, {plan['fwd_smem']} shared "
          f"bytes, {plan['fwd_blocks_per_sm']} blocks/SM, K {plan['fwd_k_width']}, ptxas "
          f"{plan['ptxas']['stem_fwd_kernel']}; C tiles {plan['dw_tile_rows']} x "
          f"{plan['tile_pixels']} pixels, {plan['dw_smem']} shared bytes, "
          f"{plan['dw_blocks_per_sm']} blocks/SM, {plan['dw_n_width']} N columns, ptxas "
          f"{plan['ptxas']['stem_dw_kernel']}", flush=True)
    rows = {"plan": plan}
    wt = torch.randn(64, 3, 7, 7, generator=g, device=dev) * 0.05
    w_hwio = wt.permute(2, 3, 1, 0).contiguous()
    w_bf = wt.to(bf16)
    flops_px = 2.0 * 147 * 64
    for n, h, with_c in STEM_SHAPES:
        w_ = h
        h2, w2 = h // 2, w_ // 2
        x = (torch.rand(n, h, w_, 3, generator=g, device=dev) * 4.0 - 2.0).to(bf16)
        yk, sk = stem.stem_fwd_cuda(x, w_hwio)
        yk2, sk2 = stem.stem_fwd_cuda(x, w_hwio)
        torch.cuda.synchronize()
        check(torch.equal(yk, yk2) and torch.equal(sk, sk2),
              f"B N={n} {h}^2: two launches on the same inputs differ")
        yp, sp = stem.stem_fwd_plain(x, wt)
        err_y = (yk.float() - yp.float()).abs()
        # about one bf16 ulp (2^-8 relative, rounding either way) plus f32
        # summation-order noise near zero
        check(bool((err_y <= 2.0 ** -7 * yp.float().abs() + 1e-4).all()),
              f"B N={n} {h}^2: y differs from the plain version by {err_y.max().item()}")
        err_s = (sk - sp).abs()
        check(bool((err_s <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all()),
              f"B N={n} {h}^2: stats differ by {err_s.max().item()} (rtol 1e-3 of each "
              f"row's max)")
        x_nchw = x.permute(0, 3, 1, 2)
        k_b = {
            "shape": [n, h, w_, 3],
            "ms": time_ms(lambda: stem.stem_fwd_cuda(x, w_hwio)),
            "plain_ms": time_ms(lambda: stem.stem_fwd_plain(x, wt)),
            # the conv alone: F.conv2d does not compute the BN statistics
            "library_ms": time_ms(lambda: F.conv2d(x_nchw, w_bf, stride=2, padding=3)),
        }
        nbytes = x.numel() * 2 + wt.numel() * 4 + yk.numel() * 2 + sk.numel() * 4
        k_b["bound_ms"], k_b["bound_by"] = bound(nbytes, flops_px * n * h2 * w2, bf16_peak)
        k_b["max_abs_err"] = err_y.max().item()
        rows[f"B N{n} {h}^2"] = k_b
        print(f"[kernel B stem_fwd] N={n} {h}x{w_}: max|dy|={k_b['max_abs_err']:.3g} "
              f"max|dstats|={err_s.max().item():.3g}, two launches bit-equal  kernel "
              f"{k_b['ms']:.4f} ms  plain {k_b['plain_ms']:.3f} ms  F.conv2d "
              f"{k_b['library_ms']:.4f} ms  bound {k_b['bound_ms']:.4f} ms ({k_b['bound_by']})",
              flush=True)
        del yk2, sk2, yp, sp, err_y
        if not with_c:
            continue
        dy = (torch.randn(n, 64, h2, w2, generator=g, device=dev) * 1e-2).to(bf16)
        ds = torch.randn(2, 64, generator=g, device=dev) * 1e-3
        dwk = stem.stem_dw_cuda(x, dy, yk, ds, 7)
        dwk2 = stem.stem_dw_cuda(x, dy, yk, ds, 7)
        torch.cuda.synchronize()
        check(torch.equal(dwk, dwk2), f"C N={n} {h}^2: two launches on the same inputs differ")
        dwp = stem.stem_dw_plain(x, dy, yk, ds, 7).permute(2, 3, 1, 0)
        err_w = (dwk - dwp).abs().max().item()
        check(err_w <= 1e-3 * dwp.abs().max().item(),
              f"C N={n} {h}^2: dW differs by {err_w} (tolerance 1e-3 of max|dW|="
              f"{dwp.abs().max().item()})")
        dY_bf = stem.fold_stats_cotangent(dy, yk, ds)
        k_c = {
            "shape": [n, h, w_, 3],
            "ms": time_ms(lambda: stem.stem_dw_cuda(x, dy, yk, ds, 7)),
            "plain_ms": time_ms(lambda: stem.stem_dw_plain(x, dy, yk, ds, 7)),
            # the weight gradient alone: the stats fold is not part of the call
            "library_ms": time_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw, (64, 3, 7, 7), dY_bf, stride=2, padding=3)),
        }
        nbytes = x.numel() * 2 + dy.numel() * 2 + yk.numel() * 2 + ds.numel() * 4 \
            + dwk.numel() * 4
        k_c["bound_ms"], k_c["bound_by"] = bound(nbytes, flops_px * n * h2 * w2, bf16_peak)
        k_c["max_abs_err"] = err_w
        rows[f"C N{n} {h}^2"] = k_c
        print(f"[kernel C stem_dw] N={n} {h}x{w_}: max|ddW|={err_w:.3g} (max|dW| "
              f"{dwp.abs().max().item():.3g}), two launches bit-equal  kernel "
              f"{k_c['ms']:.4f} ms  plain {k_c['plain_ms']:.3f} ms  conv2d_weight "
              f"{k_c['library_ms']:.4f} ms  bound {k_c['bound_ms']:.4f} ms ({k_c['bound_by']})",
              flush=True)
        del dy, dwk, dwk2, dwp
    return rows


def _misaligned(torch, t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte
    boundary: kernel E then takes its synchronous fill, kernel D
    conv_fwd_kernel at any width."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def branch_kernels(torch, dev, bc, time_ms, bound, bf16_peak, ptxas):
    """Kernels D and E at config 5's two eligible branch shapes (N = 8, the
    student's [labeled; unlabeled] batch): D plain + stats, D pre + stats
    and D as the dx conv (flipped weights, no stats); E with the stats
    cotangent fused, without and with the input transform.  Each against
    its plain version on the same inputs: y within one bf16 ulp, stats
    within 1e-3 of each row's max, dk within 1e-3 of max|dk|, dY exact.
    E also: on its asynchronous ring (counted), bit-equal over two launches,
    and through its synchronous fill (x at a 2-byte offset), which must give
    the ring's bits, with its own time.  D's post mode (dY = dy, the
    forward conv's x, mul and add): dx bit-equal to D's dx conv followed by
    ``pre_backward`` on the card and over two launches; against the plain
    version dx within one bf16 ulp of dt carried through the scale plus
    dx's own rounding (2^-6 relative: the plain dt may sit one ulp away,
    from f32 sums taken in another order), (dmul, dadd) within 1e-3 of each
    row's max.  Every D mode runs on D's kernel for the width (D96 at C =
    96, D48 at C = 48; counted), bit-equal over two launches, and again on
    conv_fwd_kernel through misaligned copies of its inputs (not counted as
    D96 or D48), held to the same bounds, bit-equal in y, dx and post's dx,
    and timed beside it; each row carries the kernel's plan and registers."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)
    d_rows, e_rows, e_plans, d_plans = {}, {}, {}, {}
    f = bc.conv3x3_fwd_cuda
    names = {bc.C96: "conv_fwd96_kernel", bc.C48: "conv_fwd48_kernel", 0: "conv_fwd_kernel"}

    def taken(before, kern, times=1):
        """Did the last ``times`` launches go to ``kern``'s counters alone?"""
        return (f.launches_c96 - before[0], f.launches_c48 - before[1]) == (
            times * int(kern == bc.C96), times * int(kern == bc.C48))

    for n, c, h in ((8, 48, 256), (8, 96, 128)):
        tag = f"N{n}_C{c}_{h}x{h}"
        x = torch.randn(n, c, h, h, generator=g, device=dev).to(bf16)
        w = torch.randn(c, c, 3, 3, generator=g, device=dev) / (3.0 * c ** 0.5)
        mul = torch.rand(c, generator=g, device=dev) + 0.5
        add = torch.randn(c, generator=g, device=dev) * 0.1
        dy = (torch.randn(n, c, h, h, generator=g, device=dev) * 1e-2).to(bf16)
        ds = torch.randn(2, c, generator=g, device=dev) * 1e-3
        act = x.numel() * 2
        flops = 2.0 * n * h * h * c * 9 * c
        w_bf = w.to(bf16)
        lib_fwd = time_ms(lambda: F.conv2d(x, w_bf, padding=1))
        kern = bc.fwd_kernel(x.shape, (x.data_ptr(),))
        check(kern == c, f"D {tag}: fwd_kernel chose {names[kern]}")
        plan = (bc.fwd96_plan if kern == bc.C96 else bc.fwd48_plan)(c, h, h)
        plan["ptxas"] = ptxas.get(names[kern], "not in the log")
        d_plans[tag] = plan
        # conv_fwd_kernel's inputs at this width: misaligned copies
        old = {"x": _misaligned(torch, x), "dy": _misaligned(torch, dy)}
        print(f"[kernel {names[kern]} plan] {tag}: {plan}", flush=True)
        for mode, pre, stats, flip in (("stats", (), True, False),
                                       ("pre+stats", (mul, add), True, False),
                                       ("dx", (), False, True)):
            src = dy if flip else x
            before = (f.launches_c96, f.launches_c48)
            y, s = bc.conv3x3_fwd_cuda(src, w, *pre, stats=stats, flip=flip)
            y2, s2 = bc.conv3x3_fwd_cuda(src, w, *pre, stats=stats, flip=flip)
            torch.cuda.synchronize()
            check(taken(before, kern, 2), f"D {tag} {mode}: {names[kern]} not taken")
            check(torch.equal(y, y2) and (s is None or torch.equal(s, s2)),
                  f"D {tag} {mode}: two launches on the same inputs differ")
            yp, sp = bc.conv3x3_fwd_plain(src, w, *pre, stats=stats, flip=flip)
            err = (y.float() - yp.float()).abs()
            check(bool((err <= 2.0 ** -7 * yp.float().abs() + 1e-4).all()),
                  f"D {tag} {mode}: y differs from the plain version by {err.max().item()}")
            if stats:
                err_s = (s - sp).abs()
                check(bool((err_s <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all()),
                      f"D {tag} {mode}: stats differ by {err_s.max().item()}")
            row = {
                "ms": time_ms(lambda: bc.conv3x3_fwd_cuda(src, w, *pre, stats=stats, flip=flip)),
                "plain_ms": time_ms(lambda: bc.conv3x3_fwd_plain(src, w, *pre, stats=stats,
                                                                  flip=flip)),
                # the conv alone: no transform, no statistics
                "library_ms": lib_fwd,
                "max_abs_err": err.max().item(),
                "kernel": names[kern],
            }
            srcm = old["dy" if flip else "x"]
            before = (f.launches_c96, f.launches_c48)
            yo, so = bc.conv3x3_fwd_cuda(srcm, w, *pre, stats=stats, flip=flip)
            torch.cuda.synchronize()
            check(taken(before, 0), f"D {tag} {mode}: a misaligned input took {names[kern]}")
            err_o = (yo.float() - yp.float()).abs()
            check(bool((err_o <= 2.0 ** -7 * yp.float().abs() + 1e-4).all()),
                  f"D {tag} {mode}: conv_fwd_kernel's y differs by {err_o.max().item()}")
            check(torch.equal(y, yo), f"D {tag} {mode}: y is not bit-equal to conv_fwd_kernel's "
                  f"({(y.float() - yo.float()).abs().max().item()})")
            if stats:
                err_so = (so - sp).abs()
                check(bool((err_so <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all()),
                      f"D {tag} {mode}: conv_fwd_kernel's stats differ by {err_so.max().item()}")
                err_ko = (s - so).abs()
                check(bool((err_ko <= 1e-3 * so.abs().amax(dim=1, keepdim=True)).all()),
                      f"D {tag} {mode}: stats differ from conv_fwd_kernel's by "
                      f"{err_ko.max().item()}")
            row.update({
                "old_kernel_ms": time_ms(lambda: bc.conv3x3_fwd_cuda(srcm, w, *pre, stats=stats,
                                                                     flip=flip)),
                "y_bit_equal_old": bool(torch.equal(y, yo)),
                "plan": {k: v for k, v in plan.items() if k != "ptxas"},
                "ptxas": plan["ptxas"],
            })
            del yo, y2
            nbytes = 2 * act + w.numel() * 4 + (2 * c * 4 if pre else 0) + (2 * c * 4 if stats else 0)
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, bf16_peak)
            d_rows[f"{tag} {mode}"] = row
            print(f"[kernel D branch_conv_fwd] {tag} {mode}: {row['kernel']} max|dy|="
                  f"{row['max_abs_err']:.3g}, two launches bit-equal  kernel {row['ms']:.3f} ms  "
                  f"conv_fwd_kernel {row['old_kernel_ms']:.3f} ms (y bit-equal "
                  f"{row['y_bit_equal_old']})  plain {row['plain_ms']:.3f} ms  F.conv2d "
                  f"{row['library_ms']:.3f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
                  flush=True)
            del y, yp
        d_rows[f"{tag} post"] = dx_post_row(torch, bc, tag, x, w, mul, add, dy, time_ms, bound,
                                            bf16_peak, lib_fwd, flops, old, kern, names[kern])
        d_rows[f"{tag} post"].update({k: d_rows[f"{tag} dx"][k] for k in ("plan", "ptxas")})
        y, _ = bc.conv3x3_fwd_cuda(x, w)
        dY_lib = bc.fold_stats_cotangent(dy, y, ds)
        lib_dw = time_ms(lambda: torch.nn.grad.conv2d_weight(x, w.shape, dY_lib, padding=1))
        plan = bc.dw_plan(c, h, h)
        plan["ptxas"] = ptxas.get(f"conv_dw_kernel<{(c + 15) // 16}>", "not in the log")
        e_plans[tag] = plan
        print(f"[kernel E plan] {tag}: {plan['rows']} dk rows per block, {plan['row_blocks']} "
              f"block(s) per slab, tiles of {plan['tile_rows']}x32 pixels, "
              f"{plan['stages']} ring stages, {plan['smem']} shared bytes, ptxas "
              f"{plan['ptxas']}", flush=True)
        xm = _misaligned(torch, x)
        for mode, pre in (("fuse", ()), ("fuse+pre", (mul, add))):
            ring0 = bc.conv3x3_dw_cuda.launches_async
            dk, dY = bc.conv3x3_dw_cuda(x, dy, y, ds, *pre)
            check(bc.conv3x3_dw_cuda.launches_async == ring0 + 1,
                  f"E {tag} {mode}: did not take the asynchronous ring")
            dk2, dY2 = bc.conv3x3_dw_cuda(x, dy, y, ds, *pre)
            torch.cuda.synchronize()
            check(torch.equal(dk, dk2) and torch.equal(dY, dY2),
                  f"E {tag} {mode}: two launches on the same inputs differ")
            dkp, dYp = bc.conv3x3_dw_plain(x, dy, y, ds, *pre)
            check(torch.equal(dY, dYp), f"E {tag} {mode}: dY is not bit-equal to the plain version "
                  f"({(dY.float() - dYp.float()).abs().max().item()})")
            err = (dk - dkp).abs().max().item()
            check(err <= 1e-3 * dkp.abs().max().item(),
                  f"E {tag} {mode}: dk differs by {err} (max|dk| {dkp.abs().max().item()})")
            ring0 = bc.conv3x3_dw_cuda.launches_async
            dks, dYs = bc.conv3x3_dw_cuda(xm, dy, y, ds, *pre)
            torch.cuda.synchronize()
            check(bc.conv3x3_dw_cuda.launches_async == ring0,
                  f"E {tag} {mode}: a misaligned input took the asynchronous ring")
            # the same tiles through the same products: the same bits
            check(torch.equal(dYs, dY) and torch.equal(dks, dk),
                  f"E {tag} {mode}: the synchronous fill differs from the ring (dk by "
                  f"{(dks - dk).abs().max().item()})")
            row = {
                "ms": time_ms(lambda: bc.conv3x3_dw_cuda(x, dy, y, ds, *pre)),
                "plain_ms": time_ms(lambda: bc.conv3x3_dw_plain(x, dy, y, ds, *pre)),
                # the weight gradient alone: no fold, no transform
                "library_ms": lib_dw,
                "max_abs_err": err,
                "sync_fill_ms": time_ms(lambda: bc.conv3x3_dw_cuda(xm, dy, y, ds, *pre)),
            }
            nbytes = 4 * act + ds.numel() * 4 + (2 * c * 4 if pre else 0) + w.numel() * 4
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, bf16_peak)
            e_rows[f"{tag} {mode}"] = row
            print(f"[kernel E branch_conv_dw] {tag} {mode}: dY exact, max|ddk|={err:.3g} (max|dk| "
                  f"{dkp.abs().max().item():.3g}), two launches bit-equal  kernel {row['ms']:.3f} "
                  f"ms (synchronous fill {row['sync_fill_ms']:.3f} ms)  plain "
                  f"{row['plain_ms']:.3f} ms  conv2d_weight {row['library_ms']:.3f} ms  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            del dk, dY, dk2, dY2, dkp, dYp, dks, dYs
        del x, xm, dy, y, dY_lib, old
    return d_rows, e_rows, e_plans, d_plans


def dx_post_row(torch, bc, tag, x, w, mul, add, dY, time_ms, bound, bf16_peak, lib_fwd, flops,
                old, kern, kname):
    """D's post mode at one shape on D's kernel ``kern`` (named ``kname``):
    checks, times and bound (see :func:`branch_kernels`); ``old``:
    misaligned copies of x and dY, to run conv_fwd_kernel beside it."""
    c = x.shape[1]
    f = bc.conv3x3_fwd_cuda
    post0, post96, post48 = f.launches_post, f.launches_c96_post, f.launches_c48_post
    dx, sums = bc.conv3x3_dx_post_cuda(dY, w, x, mul, add)
    dx2, sums2 = bc.conv3x3_dx_post_cuda(dY, w, x, mul, add)
    torch.cuda.synchronize()
    check(f.launches_post == post0 + 2, f"D {tag} post: launches not counted")
    check((f.launches_c96_post - post96, f.launches_c48_post - post48)
          == (2 * int(kern == bc.C96), 2 * int(kern == bc.C48)), f"D {tag} post: {kname} not taken")
    check(torch.equal(dx, dx2) and torch.equal(sums, sums2),
          f"D {tag} post: two launches on the same inputs differ")
    dt = bc.conv3x3_fwd_cuda(dY, w, stats=False, flip=True)[0]
    dxu, dmul, dadd = bc.pre_backward(x, dt, mul, add)
    check(torch.equal(dx, dxu), f"D {tag} post: dx is not bit-equal to D's dx conv + pre_backward "
          f"on the card ({(dx.float() - dxu.float()).abs().max().item()})")
    dxp, sp = bc.conv3x3_dx_post_plain(dY, w, x, mul, add)
    err = (dx.float() - dxp.float()).abs()
    check(bool((err <= 2.0 ** -6 * dxp.float().abs() + 1e-4).all()),
          f"D {tag} post: dx differs from the plain version by {err.max().item()}")
    err_s = (sums - sp).abs()
    check(bool((err_s <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all()),
          f"D {tag} post: (dmul, dadd) differ from the plain version by {err_s.max().item()}")
    err_u = (sums - torch.stack([dmul, dadd])).abs()
    check(bool((err_u <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all()),
          f"D {tag} post: (dmul, dadd) differ from pre_backward's by {err_u.max().item()}")

    def unfused():
        return bc.pre_backward(x, bc.conv3x3_fwd_cuda(dY, w, stats=False, flip=True)[0], mul, add)

    row = {
        "ms": time_ms(lambda: bc.conv3x3_dx_post_cuda(dY, w, x, mul, add)),
        "plain_ms": time_ms(lambda: bc.conv3x3_dx_post_plain(dY, w, x, mul, add)),
        # the chain the post mode replaces, and its elementwise part alone
        "unfused_ms": time_ms(unfused),
        "pre_backward_ms": time_ms(lambda: bc.pre_backward(x, dt, mul, add)),
        # the conv alone: no single torch call computes the function
        "library_ms": lib_fwd,
        "max_abs_err": err.max().item(),
        "sums_err": err_s.max().item(),
        "kernel": kname,
    }
    xm, dYm = old["x"], old["dy"]
    n96, n48 = f.launches_c96, f.launches_c48
    dxo, sumso = bc.conv3x3_dx_post_cuda(dYm, w, xm, mul, add)
    torch.cuda.synchronize()
    check((f.launches_c96, f.launches_c48) == (n96, n48),
          f"D {tag} post: a misaligned input took {kname}")
    err_o = (dxo.float() - dxp.float()).abs()
    check(bool((err_o <= 2.0 ** -6 * dxp.float().abs() + 1e-4).all()),
          f"D {tag} post: conv_fwd_kernel's dx differs from the plain version by "
          f"{err_o.max().item()}")
    check(torch.equal(dx, dxo), f"D {tag} post: dx is not bit-equal to conv_fwd_kernel's "
          f"({(dx.float() - dxo.float()).abs().max().item()})")
    err_so = (sums - sumso).abs()
    check(bool((err_so <= 1e-3 * sumso.abs().amax(dim=1, keepdim=True)).all()),
          f"D {tag} post: (dmul, dadd) differ from conv_fwd_kernel's by {err_so.max().item()}")
    row["old_kernel_ms"] = time_ms(lambda: bc.conv3x3_dx_post_cuda(dYm, w, xm, mul, add))
    row["dx_bit_equal_old"] = bool(torch.equal(dx, dxo))
    # dY and x read, dx written; the weights, (mul, add) and (dmul, dadd)
    nbytes = 3 * x.numel() * 2 + w.numel() * 4 + 2 * c * 4 + 2 * c * 4
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, bf16_peak)
    old_txt = (f"  conv_fwd_kernel {row['old_kernel_ms']:.3f} ms (dx bit-equal "
               f"{row['dx_bit_equal_old']})")
    print(f"[kernel D post branch_conv_dx_post] {tag}: {row['kernel']} dx bit-equal to D dx + "
          f"pre_backward, two launches bit-equal, max|ddx| vs plain {row['max_abs_err']:.3g}, "
          f"max|d(dmul, dadd)| {row['sums_err']:.3g}  kernel {row['ms']:.3f} ms{old_txt}  "
          f"unfused D dx + pre_backward "
          f"{row['unfused_ms']:.3f} ms  pre_backward alone {row['pre_backward_ms']:.3f} ms  plain "
          f"{row['plain_ms']:.3f} ms  F.conv2d {row['library_ms']:.3f} ms  bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return row


def _to(obj, dev):
    """Move the tensors of a (possibly nested) draws dataclass to ``dev``."""
    import torch

    if torch.is_tensor(obj):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj)})
    return obj


def step_losses(torch, dev, cfg, num_classes: int, seed: int, dropout):
    """One FixMatch step of ``cfg`` (2 + 2 images at its crop, random
    weights from seed 0) on the card and on the CPU, from the same batches
    and draws (``dropout``: the ASPP keep-mask, or None): (loss, sup, unsup)
    of each, computed before the update."""
    import numpy as np

    from semi_supervised_semantic_segmentation_tpu_torch.methods import common, fixmatch
    from semi_supervised_semantic_segmentation_tpu_torch.models import build_model

    crop = cfg.data.crop_size
    rng = np.random.RandomState(seed)

    def batch(labeled: bool):
        img = (rng.rand(2, crop, crop, 3) * 255).astype(np.uint8)
        lab = (rng.randint(0, num_classes, (2, crop, crop)) if labeled
               else np.full((2, crop, crop), 255)).astype(np.int32)
        return {"image": img, "label": lab, "size": np.full((2, 2), crop, np.int32)}

    bl, bu = batch(True), batch(False)
    draws = fixmatch.draw(cfg, common.to_device(bl, "cpu"), common.to_device(bu, "cpu"),
                          common.step_generator(1, 0, "cpu"))
    draws.dropout = dropout
    step_fn = fixmatch.make_train_step(cfg, 10)
    runs = {}
    for where in (dev, "cpu"):
        state = fixmatch.init_state(cfg, build_model(cfg, seed=0).to(where), 10)
        m = step_fn(state, common.to_device(bl, where), common.to_device(bu, where),
                    _to(draws, where))
        runs[str(where)] = np.array([float(m[k]) for k in ("loss", "sup_loss", "unsup_loss")])
    check(bool(np.all(np.isfinite(runs[str(dev)]))),
          f"reference: non-finite losses on the card {runs[str(dev)]}")
    return runs[str(dev)], runs["cpu"]


def reference_phase(torch, dev) -> dict:
    """The kernels inside the models against the plain path on the CPU, at a
    small size, from the same weights and inputs:

    (a) the stem segment (kernel B, BatchNorm folded from the kernel's own
        sums, ReLU, max-pool) forward and backward in train mode, N=2 at
        128^2: pooled, c1, the running statistics and dW, whose backward
        goes through kernel C with the statistics' cotangent ds != 0;
    (b) one FixMatch step at crop 64 (2 + 2 images, bf16) on the card
        (kernels A, B and C) and on the CPU (plain versions): the step's
        losses, which are computed before its update;
    (c) an HRModule with branches (16, 32) at H 64 / 32, both through the
        fused branch flow (kernels D and E), forward and backward in train
        mode: outputs, running statistics and every gradient (as one
        vector, beside the CPU's own spread under a tiny perturbation);
    (d) one config-5 FixMatch step (OHEM, ``branch_conv=pallas``, remat
        'stages:3') on a width-8 HRNet at crop 256 (branches 0 and 1
        eligible), 2 + 2 images in bf16: the step's losses.

    Only first steps are compared: a randomly initialised R50 at crop 64
    is numerically chaotic (tests/test_torch_fixmatch.py), so later steps
    of two backends part for reasons that are not the kernels'."""
    import numpy as np

    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config
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
    keep = torch.rand(4, 256, crop // 16, crop // 16,
                      generator=torch.Generator().manual_seed(0)) < 0.5
    lg, lc = step_losses(torch, dev, cfg, 21, 0, keep)
    rel = np.abs(lg - lc) / np.maximum(np.abs(lc), 1e-3)
    check(float(rel.max()) < 5e-2, f"reference: losses card {lg.tolist()} vs cpu {lc.tolist()}")
    print(f"[reference] FixMatch step, crop {crop}, 2+2 bf16: (loss, sup, unsup) card "
          f"{lg.tolist()} cpu {lc.tolist()} max rel {rel.max():.3g} (tolerance 5e-2: bf16 "
          f"convolutions of two backends through 60 layers)", flush=True)
    out["fixmatch_step"] = {"losses_card": lg.tolist(), "losses_cpu": lc.tolist()}

    # ---- (c) HRModule, branches (16, 32), both through kernels D and E
    from semi_supervised_semantic_segmentation_tpu_torch.models.hrnet import HRModule

    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(2, 16, 64, 48, generator=g).to(torch.bfloat16),
          torch.randn(2, 32, 32, 24, generator=g).to(torch.bfloat16)]
    cots = [torch.randn(x.shape, generator=g) for x in xs]
    # the module's own initialisation from a seed too: the global generator's
    # state here depends on the phases before, so its weights would differ
    # from run to run
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        mod0 = HRModule((16, 32), branch_conv="pallas")
    with torch.no_grad():
        for name, prm in mod0.named_parameters():
            if "BatchNorm" in name:  # non-trivial folds for the kernels' input transform
                prm.add_(0.1 * torch.randn(prm.shape, generator=g))
    def hrmodule_run(where, perturb=0.0):
        mod = copy.deepcopy(mod0)
        if perturb:
            with torch.no_grad():
                for prm in mod.parameters():
                    prm.mul_(1.0 + perturb * torch.randn(prm.shape, generator=g))
        mod = mod.to(where).train()
        ins = [x.to(where).clone().requires_grad_() for x in xs]
        outs = mod(ins)
        sum((o.float() * c.to(where)).sum() for o, c in zip(outs, cots)).backward()
        grads = {k: prm.grad.float().cpu() for k, prm in mod.named_parameters()}
        grads.update({f"input{i}": t.grad.float().cpu() for i, t in enumerate(ins)})
        return ([o.detach().float().cpu() for o in outs],
                {k: v.float().cpu() for k, v in mod.state_dict().items() if "running_" in k}, grads)

    def vec_rel(a, b):
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
        return math.sqrt(num / sum(float((b[k] ** 2).sum()) for k in b))

    from semi_supervised_semantic_segmentation_tpu_torch.ops.branch_conv import conv3x3_fwd_cuda

    post0 = conv3x3_fwd_cuda.launches_post
    (oc, sc, gc), (op, sp, gp) = hrmodule_run(dev), hrmodule_run("cpu")
    # each block's second conv takes the input transform: its dx conv runs
    # in D's post mode on the card
    posts = conv3x3_fwd_cuda.launches_post - post0
    check(posts > 0, "reference: HRModule launched D's post mode no time")
    for i, (a, b) in enumerate(zip(oc, op)):
        # one-ulp differences of y move the BN fold, the fma, the residual
        # and the fuse sum by a few bf16 ulps each: 2^-5 relative + 5e-2
        err = (a - b).abs()
        check(bool((err <= 2.0 ** -5 * b.abs() + 5e-2).all()),
              f"reference: HRModule output {i} differs by {err.max().item()}")
    for k in sp:
        # batch statistics of outputs that differ by a few bf16 ulps (the
        # outputs' bound above), relative to each tensor's own scale
        err = (sc[k] - sp[k]).abs().max().item()
        check(err <= 5e-2 * sp[k].abs().max().item() + 1e-3,
              f"reference: HRModule {k} differs by {err}")
    # The gradients of this module in bf16 at random init are chaotic: the
    # CPU's own move about as far as the card's differ when its weights
    # move by 1e-6 (relative), far below a bf16 ulp; the line below prints
    # that spread.  So they are compared as one vector, against 0.25; a
    # wrong kernel gradient moves it by O(1).
    rel = vec_rel(gc, gp)
    self_rel = vec_rel(hrmodule_run("cpu", 1e-6)[2], gp)
    check(rel <= 0.25, f"reference: HRModule gradients differ by {rel:.3g} as one vector")
    worst = {k: (gc[k] - b).abs().max().item() / max(b.abs().max().item(), 1e-12)
             for k, b in gp.items()}
    k_worst = max(worst, key=worst.get)
    print(f"[reference] HRModule (16, 32) at H 64/32, bf16, train fwd+bwd through D and E: "
          f"outputs max|d| {max((a - b).abs().max().item() for a, b in zip(oc, op)):.3g}; "
          f"gradients as one vector {rel:.3g} relative (tolerance 0.25; the CPU against itself "
          f"under a 1e-6 weight perturbation: {self_rel:.3g}); worst single tensor {k_worst} "
          f"{worst[k_worst]:.3g}; D post-mode launches {posts}", flush=True)
    out["hrmodule"] = {"grad_vec_rel": rel, "cpu_self_rel": self_rel, "grad_rel": worst,
                       "post_launches": posts}

    # ---- (d) one config-5 FixMatch step on a width-8 HRNet
    crop = 256
    cfg5 = load_config(CONFIG5, {
        "data.dataset": "synthetic", "data.crop_size": crop, "model.hrnet_width": 8,
        "model.hrnet_modules": (1, 1, 1), "train.labeled_batch_size": 2,
        "train.unlabeled_batch_size": 2, "method.conf_thresh": 0.0,
    })
    lg, lc = step_losses(torch, dev, cfg5, 19, 1, None)  # the HRNet head has no dropout
    rel = np.abs(lg - lc) / np.maximum(np.abs(lc), 1e-3)
    check(float(rel.max()) < 5e-2, f"reference: config-5 losses card {lg.tolist()} vs cpu {lc.tolist()}")
    print(f"[reference] config-5 FixMatch step (OHEM, branch_conv=pallas, remat stages:3), width-8 "
          f"HRNet, crop {crop}, 2+2 bf16: (loss, sup, unsup) card {lg.tolist()} cpu {lc.tolist()} "
          f"max rel {rel.max():.3g} (tolerance 5e-2)", flush=True)
    out["config5_step"] = {"losses_card": lg.tolist(), "losses_cpu": lc.tolist()}
    return out


def eval_branch_shapes(cfg, bc) -> list:
    """Config ``cfg``'s eval on its synthetic square canvas, per scale: the
    [N, C, H, W] of each HRNet branch the fused branch flow takes (C <= 128,
    ``bc.supported``), per forward, and the forwards per scale.  The
    staged path batches every window of every view of a scale into one
    forward (chunked by ``data.eval_window_batch``), so N = eval_batch_size
    x views x windows."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine.evaluator import (
        _snap, _window_starts)

    d = cfg.data
    canvas, crop = d.synthetic_canvas, d.crop_size
    stride = d.eval_stride or crop * 2 // 3
    widths = [cfg.model.hrnet_width * 2 ** i for i in range(4)]
    out = []
    for s in d.eval_scales:
        side = canvas if s == 1.0 else _snap(canvas * s)
        win = min(crop, side)
        n = cfg.train.eval_batch_size * (2 if d.eval_flip else 1) * len(
            _window_starts(side, crop, stride)) ** 2
        wb = d.eval_window_batch
        chunks = [min(wb, n - i) for i in range(0, n, wb)] if 0 < wb < n else [n]
        for m in chunks:
            shapes = [(m, c, win // 4 // 2 ** i, win // 4 // 2 ** i) for i, c in enumerate(widths)]
            out.append({"scale": s, "shapes": [sh for sh in shapes
                                               if bc.supported(sh, sh[1], sh[1])]})
    return out


def eval_d_launches(shapes: list, bc, cfg) -> dict:
    """D's launches per val pass (one val batch) from :func:`eval_branch_shapes`:
    every block of every module runs two convs per eligible branch, on the
    kernel ``fwd_kernel`` picks for the shape (16-byte aligned tensors, as
    torch allocates them); no post mode, no E in eval."""
    per_branch = sum(cfg.model.hrnet_modules) * 4 * 2
    out = {"branch_conv_fwd": 0, "branch_conv_fwd_c48": 0, "branch_conv_fwd_c96": 0}
    for fwd in shapes:
        for sh in fwd["shapes"]:
            kern = bc.fwd_kernel(sh, (0, 0))
            out["branch_conv_fwd"] += per_branch
            if kern:
                out[f"branch_conv_fwd_c{kern}"] += per_branch
    return out


def d_eval_rows(torch, dev, bc, time_ms, bound, bf16_peak, shapes: list) -> dict:
    """D at each distinct shape of config 5's eval (:func:`eval_branch_shapes`),
    as is + stats and ``pre`` + stats, against its plain version (y within
    one bf16 ulp, the statistics within 1e-3 of each row's max), with the
    kernel ``fwd_kernel`` picks; ``pre`` + stats timed (median of 10 after
    an L2 flush) beside the plain version, ``F.conv2d`` (the conv alone)
    and the bound."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    names = {bc.C96: "conv_fwd96_kernel", bc.C48: "conv_fwd48_kernel", 0: "conv_fwd_kernel"}
    rows = {}
    for n, c, h, w_ in sorted({sh for fwd in shapes for sh in fwd["shapes"]}):
        tag = f"N{n}_C{c}_{h}x{w_}"
        x = torch.randn(n, c, h, w_, generator=g, device=dev).to(bf16)
        w = torch.randn(c, c, 3, 3, generator=g, device=dev) / (3.0 * c ** 0.5)
        mul = torch.rand(c, generator=g, device=dev) + 0.5
        add = torch.randn(c, generator=g, device=dev) * 0.1
        kern = bc.fwd_kernel(x.shape, (x.data_ptr(),))
        errs = []
        for pre in ((), (mul, add)):
            y, s = bc.conv3x3_fwd_cuda(x, w, *pre)
            yp, sp = bc.conv3x3_fwd_plain(x, w, *pre)
            torch.cuda.synchronize()
            err = (y.float() - yp.float()).abs()
            check(bool((err <= 2.0 ** -7 * yp.float().abs() + 1e-4).all()),
                  f"D eval {tag} pre={bool(pre)}: y differs from the plain version by "
                  f"{err.max().item()}")
            err_s = (s - sp).abs()
            check(bool((err_s <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all()),
                  f"D eval {tag} pre={bool(pre)}: stats differ by {err_s.max().item()}")
            errs.append(err.max().item())
            del y, yp, err
        w_bf = w.to(bf16)
        row = {"kernel": names[kern], "max_abs_err": max(errs),
               "ms": time_ms(lambda: bc.conv3x3_fwd_cuda(x, w, mul, add)),
               "plain_ms": time_ms(lambda: bc.conv3x3_fwd_plain(x, w, mul, add)),
               "library_ms": time_ms(lambda: F.conv2d(x, w_bf, padding=1))}
        nbytes = 2 * x.numel() * 2 + w.numel() * 4 + 2 * c * 4 + 2 * c * 4
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * n * h * w_ * c * 9 * c, bf16_peak)
        rows[tag] = row
        print(f"[kernel D at eval] {tag} pre+stats: {row['kernel']} max|dy|={row['max_abs_err']:.3g}"
              f"  kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  F.conv2d "
              f"{row['library_ms']:.3f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
        del x
    return rows


# Limits of the card-vs-CPU eval reference, fixed from the readings that
# PERF.md records: 2 x the larger of the card's largest distance from the
# CPU's bf16 sums over sound runs and the CPU's own bf16-vs-f32 distance.
# The margin rule uses the probability limit.  Each run also holds a
# control (the kernel with its taps mirrored) against them: it must break
# each rule.
EVAL_REF_LIMITS = {"hrnet_w8_staged": {"max": 0.18, "rms": 0.010},
                   "r50_stem_pallas": {"max": 0.35, "rms": 0.031}}


def _blob_images(torch, rng, n: int, h: int, w: int):
    """uint8 (n, h, w, 3): a 4-row grid of random colours, bilinearly
    smoothed, with 10 % pixel noise -- regions, as in a photograph."""
    import torch.nn.functional as F

    grid = torch.from_numpy(rng.rand(n, 3, 4, max(4 * w // h, 1)).astype("float32"))
    x = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False)
    x = x + 0.1 * torch.from_numpy(rng.rand(n, 3, h, w).astype("float32"))
    return (x.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _conditioned_model(torch, cfg, seed: int):
    """A seeded f32 model conditioned so that bf16 rounding moves its
    output little: the last BatchNorm scale of every residual block at 0.25
    (a random-init BatchNorm-ReLU net is chaotic: it amplifies a 1e-3
    input change about 60-fold), then every running statistic set from one
    train-mode forward of two calibration images (momentum 0)."""
    import numpy as np

    from semi_supervised_semantic_segmentation_tpu_torch.models import build_model, resnet
    from semi_supervised_semantic_segmentation_tpu_torch.models.layers import BatchNorm
    from semi_supervised_semantic_segmentation_tpu_torch.ops import augment

    model = build_model(cfg, seed=seed)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    momenta = [b.momentum for b in bns]
    crop = cfg.data.crop_size
    x = augment.canvas_normalize_eval(_blob_images(torch, np.random.RandomState(seed + 1), 2,
                                                   crop, crop),
                                      tuple(cfg.data.mean), tuple(cfg.data.std), torch.float32)
    with torch.no_grad():
        for blk in model.modules():
            last = (blk.conv3 if isinstance(blk, resnet.Bottleneck) else
                    blk.conv2 if isinstance(blk, resnet.BasicBlock) else None)
            if last is not None:
                last.Norm_0.BatchNorm_0.weight.mul_(0.25)
        for b in bns:
            b.momentum = 0.0
        model.train()
        model(x)
    for b, m in zip(bns, momenta):
        b.momentum = m
    return model.eval()


def eval_reference_phase(torch, dev) -> dict:
    """(e) a width-8 HRNet with config 5's head and ``branch_conv=pallas``
    through the staged eval path (sliding at crop 256 / stride 192 on a
    256 x 384 canvas, flip, scales 0.75 and 1.0: D on the card in the 256^2
    windows), and (f) config 3's R50 + DeepLabV3+ with ``stem_impl=pallas``
    through its whole + flip protocol at 256^2 (B on the card, once per
    view).  The same seeded, conditioned weights (:func:`_conditioned_model`)
    and uint8 images of smooth colour regions (2 per case) on the card
    (bf16, the kernels), on the CPU (bf16, the plain versions) and on the
    CPU in f32.

    Limits (:data:`EVAL_REF_LIMITS`, fixed): the card's probability sums lie
    within ``max`` of the CPU's bf16 ones, their RMS distance within
    ``rms``, and the confusion matrices differ only in pixels whose top-2
    margin (CPU bf16) is under ``max``; the count of those pixels, the
    share of all pixels under that margin, and the CPU's own bf16-vs-f32
    distances are printed.  A control -- the card's kernel with its taps
    mirrored -- must break each of the three rules."""
    import numpy as np

    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config
    from semi_supervised_semantic_segmentation_tpu_torch.engine import evaluator
    from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
    from semi_supervised_semantic_segmentation_tpu_torch.ops import branch_conv, stem

    cases = {
        # 3 modules x 4 blocks x 2 convs x 2 branches in the 256^2 windows
        # (branch 0 at 64^2, branch 1 at 32^2); the 192-row windows of
        # scale 0.75 leave the branches at H 48 / 24, not eligible
        "hrnet_w8_staged": (CONFIG5, {
            "data.crop_size": 256, "data.eval_stride": 192, "data.eval_scales": (0.75, 1.0),
            "model.hrnet_width": 8, "model.hrnet_modules": (1, 1, 1)}, (2, 256, 384),
            (branch_conv.conv3x3_fwd_cuda, "launches"), 48, (branch_conv, "conv3x3_fwd")),
        "r50_stem_pallas": (CONFIG3, {"data.crop_size": 256, "model.stem_impl": "pallas"},
                            (2, 256, 256), (stem.stem_fwd_cuda, "launches"), 2,
                            (stem, "stem_fwd")),
    }

    def distances(p, ref, valid, tol):
        top2 = ref.topk(2, dim=1).values
        margin = top2[:, 0] - top2[:, 1]
        moved = valid & (p.argmax(1) != ref.argmax(1))
        return {"max_dprob": (p - ref).abs().max().item(),
                "rms_dprob": (p - ref).pow(2).mean().sqrt().item(),
                "pixels_moved": int(moved.sum()),
                "confident_moved": int((moved & (margin >= tol)).sum()),
                "share_under_margin": (valid & (margin < tol)).sum().item() / valid.sum().item()}

    out = {}
    for name, (path, over, (n, h, w), (fn, attr), launches, (mod, fname)) in cases.items():
        lim = EVAL_REF_LIMITS[name]
        cfgs = {dt: load_config(path, {"data.dataset": "synthetic", **over,
                                       "model.compute_dtype": dt})
                for dt in ("bfloat16", "float32")}
        cfg = cfgs["bfloat16"]
        model_f32 = _conditioned_model(torch, cfgs["float32"], seed=5)
        model = build_model(cfg, seed=5)
        model.load_state_dict(model_f32.state_dict())
        model.eval()
        rng = np.random.RandomState(7)
        batch = {"image": _blob_images(torch, rng, n, h, w),
                 "label": torch.from_numpy(rng.randint(
                     0, cfg.data.num_classes, (n, h, w)).astype(np.int32))}
        probs_fn, cm_fn = evaluator.make_probs(cfg), evaluator.make_evaluator(cfg)
        real = getattr(mod, fname)  # the kernel's dispatcher: (x, w OIHW, ...)

        def mirrored(x, w, *rest, real=real, **kw):
            return real(x, w.flip(2, 3), *rest, **kw)

        def run(m, where, control=False):
            b = {k: v.to(where) for k, v in batch.items()}
            before = getattr(fn, attr)
            setattr(mod, fname, mirrored if control else real)
            try:
                with torch.no_grad():
                    p = probs_fn(m, b).float().cpu()
                    cm = cm_fn(m, b).cpu()
            finally:
                setattr(mod, fname, real)
            return p, cm, getattr(fn, attr) - before

        on_card = copy.deepcopy(model).to(dev)
        pc, cmc, lc = run(on_card, dev)
        p_ctrl = run(on_card, dev, control=True)[0]
        del on_card
        pb, cmb, _ = run(model, "cpu")
        pf = run(model_f32, "cpu")[0]
        check(lc == 2 * launches, f"eval reference {name}: the kernel launched {lc} times on "
              f"the card, expected {2 * launches} (probabilities and confusion matrix)")
        valid = batch["label"] != cfg.data.ignore_index
        card = distances(pc, pb, valid, lim["max"])
        noise = distances(pb, pf, valid, lim["max"])
        ctrl = distances(p_ctrl, pb, valid, lim["max"])
        check(bool(torch.isfinite(pc).all()), f"eval reference {name}: non-finite probabilities")
        check(card["max_dprob"] <= lim["max"], f"eval reference {name}: probabilities differ "
              f"by {card['max_dprob']} (limit {lim['max']})")
        check(card["rms_dprob"] <= lim["rms"], f"eval reference {name}: RMS distance "
              f"{card['rms_dprob']} (limit {lim['rms']})")
        check(card["confident_moved"] == 0, f"eval reference {name}: "
              f"{card['confident_moved']} pixels with a top-2 margin >= {lim['max']} moved")
        check(card["pixels_moved"] > 0 or torch.equal(cmc, cmb),
              f"eval reference {name}: confusion matrices differ with no pixel moved")
        check(int(cmc.sum()) == int(valid.sum()),
              f"eval reference {name}: the card counted {int(cmc.sum())} pixels")
        check(ctrl["max_dprob"] > lim["max"] and ctrl["rms_dprob"] > lim["rms"]
              and ctrl["confident_moved"] > 0,
              f"eval reference {name}: a rule passed the control (taps mirrored): {ctrl}")
        out[name] = {**card, "limits": lim, "bf16_vs_f32": noise, "control": ctrl,
                     "pixels": int(valid.sum()), "kernel_launches": lc,
                     "staged": evaluator.use_staged(cfg)}
        print(f"[reference] eval {name} ({'staged' if out[name]['staged'] else 'fused'} path, "
              f"{n}x{h}x{w}, bf16): card vs CPU probability sums max|d| "
              f"{card['max_dprob']:.4g} (limit {lim['max']}), RMS {card['rms_dprob']:.4g} "
              f"(limit {lim['rms']}); {card['pixels_moved']} of {int(valid.sum())} pixels "
              f"moved, {card['confident_moved']} with a margin >= {lim['max']} "
              f"({card['share_under_margin']:.3f} of pixels lie under it); CPU bf16 vs f32 "
              f"max|d| {noise['max_dprob']:.4g}, RMS {noise['rms_dprob']:.4g}, "
              f"{noise['pixels_moved']} moved; control (taps mirrored) max|d| "
              f"{ctrl['max_dprob']:.4g}, RMS {ctrl['rms_dprob']:.4g}, "
              f"{ctrl['confident_moved']} confident pixels moved; kernel launches on the card "
              f"{lc}", flush=True)
    return out


# card (bf16, kernels B and C) against the CPU (bf16, plain versions): the
# step's losses (max relative distance) and its update of every parameter
# as one vector (relative distance).  Fixed at 2x the largest of the card's
# reading and the CPU's own bf16-vs-f32 readings, on the card's machine and
# on a development CPU (NVIDIA H100 80GB HBM3, 700.00 W): supervised losses
# 1.07e-4 / 1.09e-4 / 2.06e-4, update 0.085 / 0.100 / 0.099; Mean Teacher
# losses 2.5e-3 / 7.7e-3 / 6.9e-3, update 0.095 / 0.125 / 0.124; CPS
# separate losses 4.2e-4 / 5.2e-4 / 4.1e-4, update 0.102 / 0.133 / 0.133,
# stacked losses 1.7e-4 / 4.5e-4 / 4.3e-4, update 0.100 / 0.134 / 0.133
STEP_REF_LIMITS = {"supervised_unet_r18": {"loss": 4.2e-4, "update": 0.20},
                   "mean_teacher_unet_r18": {"loss": 0.016, "update": 0.25},
                   "cps_separate_unet_r18": {"loss": 1.04e-3, "update": 0.27},
                   "cps_stacked_unet_r18": {"loss": 1.04e-3, "update": 0.27}}
# config 4's method on config 1's model: both nets U-Net/R18, OHEM as config 4
CPS_UNET = {"model.backbone": "resnet18", "model.decoder": "unet", "model.output_stride": 32}


def unet_step_run(torch, name: str, where, dtype: str) -> dict:
    """One step of config 1's supervised method, config 2's Mean Teacher or
    config 4's CPS in either form (:data:`STEP_REF_LIMITS` names) on
    U-Net/R18 at 128^2, 2 (+ 2) images, ``model.stem_impl=pallas``, in
    ``dtype`` on ``where``: the same seeded, conditioned weights
    (:func:`_conditioned_model`; CPS's net2 from another seed), smooth
    colour images and draws every time.  Returns the step's losses
    (computed before its update), its update of every parameter and the
    stem kernels' launches."""
    import numpy as np

    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config
    from semi_supervised_semantic_segmentation_tpu_torch.methods import common, get_method
    from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
    from semi_supervised_semantic_segmentation_tpu_torch.ops import stem

    method = next(m for m in ("supervised", "mean_teacher", "cps") if name.startswith(m))
    path = {"supervised": CONFIG1, "mean_teacher": CONFIG2, "cps": CONFIG4}[method]
    over = {"data.dataset": "synthetic", "data.crop_size": 128, "model.stem_impl": "pallas",
            "train.labeled_batch_size": 2, "train.unlabeled_batch_size": 2,
            "method.rampup_iters": 0}
    if name.startswith("cps"):
        over.update({**CPS_UNET, "method.cps_impl": name.split("_")[1]})
    cfg = load_config(path, {**over, "model.compute_dtype": dtype})
    cfg32 = load_config(path, {**over, "model.compute_dtype": "float32"})
    rng = np.random.RandomState(7)
    lab = {"image": _blob_images(torch, rng, 2, 128, 128).numpy(),
           "label": rng.randint(0, cfg.data.num_classes, (2, 128, 128)).astype(np.int32),
           "size": np.full((2, 2), 128, np.int32)}
    unlab = {"image": _blob_images(torch, rng, 2, 128, 128).numpy(),
             "label": np.full((2, 128, 128), 255, np.int32), "size": lab["size"]}
    method = get_method(method)
    g = common.step_generator(1, 0, "cpu")
    lab_c, unlab_c = common.to_device(lab, "cpu"), common.to_device(unlab, "cpu")
    model = build_model(cfg, seed=5)
    model.load_state_dict(_conditioned_model(torch, cfg32, seed=5).state_dict())
    model = model.to(where)
    if cfg.method.name == "cps":
        draws = method.draw(cfg, model, lab_c, unlab_c, g)  # U-Net: no dropout masks
    elif method.uses_unlabeled:
        draws = method.draw(cfg, lab_c, unlab_c, g)
    else:
        draws = method.draw(cfg, lab_c, g)
    if hasattr(draws, "dropout"):
        draws.dropout = None  # U-Net has no dropout
    state = method.init_state(cfg, model, 10)
    if state.model2 is not None:
        state.model2.load_state_dict(_conditioned_model(torch, cfg32, seed=6).state_dict())
    nets = {"": model} if state.model2 is None else {"net1.": model, "net2.": state.model2}

    def params():
        return {p + k: v for p, net in nets.items() for k, v in net.named_parameters()}

    before = {k: p.detach().float().cpu().clone() for k, p in params().items()}
    b0, c0 = stem.stem_fwd_cuda.launches, stem.stem_dw_cuda.launches
    m = method.make_train_step(cfg, 10)(
        state, common.to_device(lab, where),
        common.to_device(unlab, where) if method.uses_unlabeled else None, _to(draws, where))
    cols = ("loss", "sup_loss", "cps_loss" if cfg.method.name == "cps" else "unsup_loss")
    cols = cols if method.uses_unlabeled else ("loss",)
    return {"losses": np.array([float(m[k]) for k in cols]),
            "update": {k: p.detach().float().cpu() - before[k] for k, p in params().items()},
            "launches": (stem.stem_fwd_cuda.launches - b0, stem.stem_dw_cuda.launches - c0)}


def unet_step_reference(torch, dev) -> dict:
    """(g) one supervised U-Net/R18 step (config 1), (h) one Mean-Teacher
    step (config 2) and (i) one CPS step (config 4's method, U-Net/R18
    nets) in each form, ``separate`` and ``stacked`` (``torch.func.vmap``),
    at 128^2 (:func:`unet_step_run`) on the card (kernels B and C) against
    the CPU (their plain versions), in bf16, and the CPU's own bf16-vs-f32
    distance beside: losses within ``loss`` (relative), the update as one
    vector within ``update`` (relative) of :data:`STEP_REF_LIMITS`; B
    launched once per forward, C once per backward (CPS: twice each, in
    both forms); the card's ``stacked`` losses and update against its
    ``separate`` ones within the same limits."""
    import numpy as np

    def vec_rel(a, b):
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
        return math.sqrt(num / sum(float((b[k] ** 2).sum()) for k in b))

    def loss_rel(a, b):
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max())

    out = {}
    for name, lim in STEP_REF_LIMITS.items():
        card = unet_step_run(torch, name, dev, "bfloat16")
        cpu = unet_step_run(torch, name, "cpu", "bfloat16")
        f32 = unet_step_run(torch, name, "cpu", "float32")
        r = {"losses_card": card["losses"].tolist(), "losses_cpu": cpu["losses"].tolist(),
             "loss_rel": loss_rel(card["losses"], cpu["losses"]),
             "update_rel": vec_rel(card["update"], cpu["update"]),
             "cpu_bf16_vs_f32": {"loss_rel": loss_rel(cpu["losses"], f32["losses"]),
                                 "update_rel": vec_rel(cpu["update"], f32["update"])},
             "limits": lim, "launches": card["launches"]}
        # Mean Teacher: teacher + student forwards; CPS: one per net
        want = (2, 1) if name.startswith("mean_teacher") else (
            (2, 2) if name.startswith("cps") else (1, 1))
        check(bool(np.all(np.isfinite(card["losses"]))),
              f"reference {name}: non-finite losses on the card {r['losses_card']}")
        check(r["loss_rel"] <= lim["loss"], f"reference {name}: losses card "
              f"{r['losses_card']} vs cpu {r['losses_cpu']} ({r['loss_rel']:.4g}, limit "
              f"{lim['loss']})")
        check(r["update_rel"] <= lim["update"], f"reference {name}: the update differs by "
              f"{r['update_rel']:.4g} as one vector (limit {lim['update']})")
        check(tuple(card["launches"]) == want, f"reference {name}: (B, C) launched "
              f"{card['launches']} times, expected {want}")
        print(f"[reference] {name} step at 128^2, bf16, stem_impl=pallas: losses card "
              f"{r['losses_card']} cpu {r['losses_cpu']}, max rel {r['loss_rel']:.4g} (limit "
              f"{lim['loss']}); update as one vector {r['update_rel']:.4g} (limit "
              f"{lim['update']}); CPU bf16 vs f32: losses {r['cpu_bf16_vs_f32']['loss_rel']:.4g}"
              f", update {r['cpu_bf16_vs_f32']['update_rel']:.4g}; (B, C) launches on the "
              f"card {card['launches']}", flush=True)
        out[name] = r
        r["_card"] = card
    sep, stk = (out[f"cps_{f}_unet_r18"] for f in ("separate", "stacked"))
    lim = STEP_REF_LIMITS["cps_stacked_unet_r18"]
    forms = {"loss_rel": loss_rel(stk["_card"]["losses"], sep["_card"]["losses"]),
             "update_rel": vec_rel(stk["_card"]["update"], sep["_card"]["update"])}
    check(forms["loss_rel"] <= lim["loss"] and forms["update_rel"] <= lim["update"],
          f"reference cps: stacked against separate on the card {forms} (limits {lim})")
    print(f"[reference] cps on the card, stacked against separate: losses "
          f"{forms['loss_rel']:.4g}, update {forms['update_rel']:.4g} (limits {lim})", flush=True)
    for r in out.values():
        r.pop("_card")
    out["cps_stacked_vs_separate_card"] = forms
    return out


def checkpoint_round_trip(torch, trainer, cfg) -> dict:
    """Config 3's trained state -> ``export_reference_checkpoint`` -> a
    fresh model through the eval entry point's loader (``eval.load_state``)
    -> the val pass's confusion matrix, equal to the trained state's."""
    import numpy as np

    from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval
    from semi_supervised_semantic_segmentation_tpu_torch.engine import compat, evaluator

    path = os.path.join(REPO, "build", "chip_smoke_checkpoint.pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    compat.export_reference_checkpoint(path, trainer.state, {"epoch": 0,
                                                             "best_miou": trainer.best_miou}, cfg)
    mb = os.path.getsize(path) / 1e6
    loader = evaluator.val_loader(cfg)
    step = evaluator.make_evaluator(cfg)
    try:
        cm_a = evaluator.eval_confusion(step, evaluator.inference_model(trainer.state,
                                                                        trainer.method),
                                        loader, trainer.device)
        state, method, meta = port_eval.load_state(cfg, path, trainer.device)
        cm_b = evaluator.eval_confusion(step, evaluator.inference_model(state, method), loader,
                                        trainer.device)
    finally:
        loader.close()
        os.remove(path)
    check(np.array_equal(cm_a, cm_b), "checkpoint round trip: the confusion matrix changed")
    check(state.step == trainer.state.step, "checkpoint round trip: the step changed")
    print(f"[slice] config 3 checkpoint round trip ({mb:.1f} MB reference-layout file, loaded "
          f"through the eval entry point): confusion matrix equal {np.array_equal(cm_a, cm_b)} "
          f"over {int(cm_a.sum())} pixels, step {state.step}", flush=True)
    del state
    return {"file_mb": mb, "cm_equal": bool(np.array_equal(cm_a, cm_b)),
            "pixels": int(cm_a.sum())}


def val_stem_launches(cfg) -> int:
    """Kernel B's launches in one val pass of the fused whole-image path:
    one per view (the image, its mirror with ``eval_flip``) per scale per
    batch of the synthetic val set."""
    check(cfg.data.eval_mode == "whole", f"val_stem_launches: {cfg.data.eval_mode} mode")
    n_val = max(cfg.data.synthetic_size // 2, 8)
    views = 2 if cfg.data.eval_flip else 1
    return math.ceil(n_val / cfg.train.eval_batch_size) * views * len(cfg.data.eval_scales)


def trace_summary(path: str, nsteps: int) -> dict:
    """Per-step numbers of a ``torch.profiler`` Chrome trace: its wall span;
    host ops (``cpu_op``): their count and the time covered by the
    outermost ones (nested ops counted once); CUDA runtime calls and
    kernels: count and summed duration."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") != "Trace"]
    out = {}
    for cat in ("cpu_op", "cuda_runtime", "kernel"):
        evs = sorted((e for e in events if e.get("cat") == cat),
                     key=lambda e: (e.get("tid", 0), e["ts"]))
        ms, end, tid = 0.0, -1.0, None
        for e in evs:
            if cat != "cpu_op" or e.get("tid") != tid or e["ts"] >= end:
                ms += e.get("dur", 0.0) / 1e3
                tid, end = e.get("tid"), e["ts"] + e.get("dur", 0.0)
        out[cat] = {"count": len(evs) / nsteps, "ms": ms / nsteps}
    span = (max(e["ts"] + e.get("dur", 0.0) for e in events)
            - min(e["ts"] for e in events)) / 1e3 if events else 0.0
    return {"wall_ms_per_step": span / nsteps, "per_step": out}


def profile_trace_check(torch, trainer, cfg) -> dict:
    """``train.profile_steps``: the trainer's own trace of steps 2 .. 2 + n
    exists under ``<work_dir>/profile``; its path, size and per-step
    summary."""
    out = os.path.join(cfg.train.work_dir, "profile")
    names = sorted(os.listdir(out)) if os.path.isdir(out) else []
    check(len(names) == 1, f"profile_steps: expected one trace in {out}, found {names}")
    if not names:
        return {}
    path = os.path.join(out, names[0])
    mb = os.path.getsize(path) / 1e6
    check(mb > 0, f"profile_steps: {path} is empty")
    summary = trace_summary(path, cfg.train.profile_steps + 1)
    print(f"[slice] config 1 train.profile_steps={cfg.train.profile_steps}: trace {path} "
          f"({mb:.2f} MB); per step {summary['wall_ms_per_step']:.2f} ms wall, "
          f"{ {k: (round(v['count']), round(v['ms'], 3)) for k, v in summary['per_step'].items()} }"
          f" (events, ms)", flush=True)
    return {"path": path, "mb": mb, **summary}


def resume_on_card(torch, trainer, cfg, label: str) -> dict:
    """Config 2 or 4: ``fit`` left one rolling slot (``checkpoint_interval``
    1) and one best slot.  A second Trainer with ``train.resume=auto`` and
    ``train.epochs=2`` restores the rolling slot -- model, teacher or CPS's
    second net, every net's momentum and step bit-equal to the trained
    state, ``start_epoch`` 1 -- and trains epoch 1 with finite losses; the
    eval entry point's loader reads the ``checkpoints`` directory (before
    the second run adds its slot) and gives the trained state's confusion
    matrix, whose mIoU is the ``val`` record's."""
    import numpy as np

    from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval
    from semi_supervised_semantic_segmentation_tpu_torch.config import update_config
    from semi_supervised_semantic_segmentation_tpu_torch.engine import compat, evaluator
    from semi_supervised_semantic_segmentation_tpu_torch.engine.checkpoint import (
        CheckpointManager)
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer
    from semi_supervised_semantic_segmentation_tpu_torch.ops.metrics import iou_from_confusion

    work = cfg.train.work_dir
    rolling = CheckpointManager(os.path.join(work, "checkpoints")).steps()
    best = CheckpointManager(os.path.join(work, "checkpoints_best")).steps()
    check(rolling == [trainer.state.step], f"{label}: rolling slots {rolling}, expected "
          f"[{trainer.state.step}]")
    check(len(best) == 1, f"{label}: checkpoints_best holds {best}, expected one slot")
    slot_mb = sum(os.path.getsize(os.path.join(work, "checkpoints", str(rolling[-1]), n))
                  for n in os.listdir(os.path.join(work, "checkpoints", str(rolling[-1])))) / 1e6

    def tensors(state):
        nets = {"model": state.model, "ema": state.ema_model, "model2": state.model2}
        out = {f"{n}.{k}": v for n, net in nets.items() if net is not None
               for k, v in net.state_dict().items()}
        out.update({f"momentum.{i}.{k}": v for i, net in enumerate(state.nets())
                    for k, v in compat._named_buffers(state, net).items()})
        return out

    loader = evaluator.val_loader(cfg)
    step = evaluator.make_evaluator(cfg)
    try:
        cm_a = evaluator.eval_confusion(step, evaluator.inference_model(trainer.state,
                                                                        trainer.method),
                                        loader, trainer.device)
        state, method, meta = port_eval.load_state(cfg, os.path.join(work, "checkpoints"),
                                                   trainer.device)
        cm_b = evaluator.eval_confusion(step, evaluator.inference_model(state, method), loader,
                                        trainer.device)
    finally:
        loader.close()
    with open(os.path.join(work, "metrics.jsonl")) as f:
        val = [json.loads(line)["val"] for line in f if '"val"' in line]
    miou = float(iou_from_confusion(cm_a)[1])
    check(np.array_equal(cm_a, cm_b), f"{label}: the checkpoint directory's confusion matrix "
          "differs from the trained state's")
    check(bool(val) and val[0]["miou"] == miou, f"{label}: the val record's mIoU "
          f"{val[0]['miou'] if val else None} is not the trained state's {miou}")
    t0 = time.time()
    second = Trainer(update_config(cfg, {"train.resume": "auto", "train.epochs": 2}))
    restore_s = time.time() - t0
    want, got = tensors(trainer.state), tensors(second.state)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    check(not differ and set(want) == set(got), f"{label} resume: tensors differ {differ[:5]}")
    check(second.state.step == trainer.state.step and second.start_epoch == 1,
          f"{label} resume: step {second.state.step} (saved {trainer.state.step}), "
          f"start_epoch {second.start_epoch}")
    losses = []
    inner = second.train_step

    def record(state, lab, unlab):
        m = inner(state, lab, unlab)
        losses.append(float(m["loss"]))
        return m

    second.train_step = record
    second.fit()
    check(len(losses) == second.iters_per_epoch and all(math.isfinite(v) for v in losses),
          f"{label} resume: epoch 1 losses {losses}")

    print(f"[slice] {label} resume on the card: rolling slot {rolling} ({slot_mb:.1f} MB), "
          f"best slot {best}; a Trainer with train.resume=auto restored "
          f"{sorted({k.split('.')[0] for k in want})}, momentum and step {trainer.state.step} bit-equal "
          f"{not differ} in {restore_s:.2f} s (its construction), start_epoch "
          f"{second.start_epoch}; epoch 1 losses {[round(v, 4) for v in losses]}; the eval "
          f"entry point's loader on checkpoints/: confusion matrix equal "
          f"{np.array_equal(cm_a, cm_b)} over {int(cm_a.sum())} pixels, mIoU {miou:.4f} = the "
          f"val record's", flush=True)
    start_epoch = second.start_epoch
    del second, state
    return {"rolling": rolling, "best": best, "slot_mb": slot_mb, "bit_equal": not differ,
            "start_epoch": start_epoch, "epoch1_losses": losses, "cm_equal": bool(np.array_equal(cm_a, cm_b)),
            "miou": miou, "trainer_construction_s": restore_s}


def staged_forwards(cfg) -> int:
    """Model forwards (so kernel B's launches) of one val pass of the staged
    path on ``cfg``'s synthetic square canvases: per val batch and scale,
    every window of every view in one forward, chunked by
    ``data.eval_window_batch``."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine.evaluator import (
        _snap, _window_starts)

    d = cfg.data
    stride = d.eval_stride or d.crop_size * 2 // 3
    per_batch = 0
    for s in d.eval_scales:
        side = d.synthetic_canvas if s == 1.0 else _snap(d.synthetic_canvas * s)
        n = cfg.train.eval_batch_size * (2 if d.eval_flip else 1) * len(
            _window_starts(side, d.crop_size, stride)) ** 2
        wb = d.eval_window_batch
        per_batch += math.ceil(n / wb) if 0 < wb < n else 1
    return per_batch * math.ceil(max(d.synthetic_size // 2, 8) / cfg.train.eval_batch_size)


STACKED_STEPS = 4


def stacked_steps(torch, cfg, counters: dict, expected: dict, out: dict) -> dict:
    """Config 4 in CPS's ``stacked`` form (``torch.func.vmap`` over the two
    nets): a Trainer of the same config and seeds with
    ``method.cps_impl=stacked`` runs :data:`STACKED_STEPS` steps (no eval).
    Every counter is set to 0 just before and read just after; each step
    must launch each kernel ``expected`` times (B and C once per net, from
    the stem's vmap rule).  Losses finite; step 0 starts from the state,
    batch and draws of the ``separate`` run's step 0, so its loss is held
    to that run's within the phase-3 loss limit; the last two steps run
    under the profiler.  The launches go to ``out["launches"]``."""
    from semi_supervised_semantic_segmentation_tpu_torch.config import update_config
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer

    with open(os.path.join(cfg.train.work_dir, "metrics.jsonl")) as f:
        separate0 = next(json.loads(line)["train"]["loss"] for line in f if '"train"' in line)
    work = cfg.train.work_dir + "_stacked"
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(update_config(cfg, {"method.cps_impl": "stacked", "train.work_dir": work}))
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    losses, times, per_step, window = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f, a in counters.values():
        setattr(f, a, 0)
    try:
        for i, (lab, unlab) in enumerate(trainer.batches(0)):
            if i == STACKED_STEPS:
                break
            before = {k: getattr(f, a) for k, (f, a) in counters.items()}
            if i == STACKED_STEPS - 2:
                prof.start()
                window.append(time.time())
            t0 = time.time()
            m = trainer.train_step(trainer.state, lab, unlab)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            per_step.append({k: getattr(f, a) - before[k] for k, (f, a) in counters.items()})
        window.append(time.time())
        prof.stop()
    finally:
        trainer.close()
    out["launches"] = {k: getattr(f, a) for k, (f, a) in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(losses) == STACKED_STEPS and all(math.isfinite(v) for v in losses),
          f"config 4 stacked: losses {losses}")
    for i, d in enumerate(per_step):
        check(d == expected, f"config 4 stacked: step {i} launched {d}, expected {expected}")
    lim = STEP_REF_LIMITS["cps_stacked_unet_r18"]["loss"]
    rel = abs(losses[0] - separate0) / max(abs(separate0), 1e-3)
    check(rel <= lim, f"config 4 stacked: step 0 loss {losses[0]} vs separate's {separate0} "
          f"({rel:.4g}, limit {lim})")
    ms = statistics.median(times[1:STACKED_STEPS - 2]) * 1e3
    print(f"[slice] config 4 stacked (torch.func.vmap over both nets), {STACKED_STEPS} steps: "
          f"losses {[round(v, 4) for v in losses]}; step 0 {losses[0]:.5f} vs separate's "
          f"{separate0:.5f} (rel {rel:.3g}, limit {lim}); launches per step {per_step[-1]}; "
          f"{ms:.1f} ms/step (median of steps 2-{STACKED_STEPS - 2}); peak memory "
          f"{peak_gb:.2f} GB; step times s {[round(t, 3) for t in times]}", flush=True)
    breakdown = device_breakdown(torch, prof, (window[1] - window[0]) * 1e3, 2)
    shutil.rmtree(work, ignore_errors=True)
    del trainer
    return {"losses": losses, "step_s": times, "ms_per_step": ms, "peak_gb": peak_gb,
            "separate_step0_loss": separate0, "step0_rel": rel, "per_step_launches": per_step,
            "profile": breakdown}


def slice_phase(torch, label: str, config_path: str, overrides: dict, counters: dict,
                expected: dict, steps: int, eval_expected: dict, after_fit=None):
    """One config through the Trainer on synthetic data for ``steps`` steps.
    Every launch counter is set to 0 just before and read just after; each
    step must launch each kernel ``expected`` times.  Steps 3..steps-2 are
    timed; the last two run under torch.profiler for the breakdown of device
    time by kernel.  ``fit`` ends in one evaluation (``train.epochs=1``):
    the training launches and peak memory are read just before it, then
    the counters and the peak are reset and the val pass is counted
    (``eval_expected`` per pass) and measured on its own; a second pass
    (warm: no new shapes) is timed, and a third, profiled, gives its device
    time by kernel group; neither writes a record.
    ``after_fit(torch, trainer, cfg)`` runs last.  Returns (record,
    training launches, launches per val pass)."""
    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config
    from semi_supervised_semantic_segmentation_tpu_torch.engine.evaluator import (
        inference_model, run_eval, use_staged)
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer

    warm, profiled = 2, 2
    # what an earlier phase left behind (a trainer in a reference cycle)
    # would count in this run's peak memory: collect it, and report what
    # stays allocated
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    # the work directory (metrics, checkpoints: 0.5-0.8 GB a slot for
    # configs 3 and 5) stays in the git-ignored build tree, and starts empty
    work_dir = os.path.join(REPO, "build", f"chip_smoke_{label.replace(' ', '')}")
    shutil.rmtree(work_dir, ignore_errors=True)
    cfg = load_config(config_path, {
        "data.dataset": "synthetic", "data.num_workers": 8, "train.iters_per_epoch": steps,
        "train.epochs": 1, "train.log_interval": 1, "train.work_dir": work_dir, **overrides,
    })
    trainer = Trainer(cfg)  # default device: CUDA
    inner = trainer.train_step
    per_step, losses, times = [], [], []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    window = []

    def counted(state, lab, unlab):
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        if len(times) == steps - profiled:
            prof.start()
            window.append(time.time())
        t0 = time.time()
        metrics = inner(state, lab, unlab)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        per_step.append({k: getattr(f, a) - before[k] for k, (f, a) in counters.items()})
        losses.append(float(metrics["loss"]))
        if len(times) == steps:
            window.append(time.time())
            prof.stop()
        return metrics

    inner_eval = trainer.evaluate
    ev = {}

    def counted_eval(epoch):
        torch.cuda.synchronize()
        ev["train_launches"] = {k: getattr(f, a) for k, (f, a) in counters.items()}
        ev["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for f, a in counters.values():
            setattr(f, a, 0)
        ev["held_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        miou = inner_eval(epoch)
        torch.cuda.synchronize()
        ev["seconds"] = time.time() - t0
        ev["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        ev["launches"] = {k: getattr(f, a) for k, (f, a) in counters.items()}
        ev["miou"] = miou
        # the first pass meets new shapes (cuDNN's algorithm search, the
        # allocator's first blocks): the pass again, warm, is the one timed;
        # then once more under the profiler, for its device time
        model = inference_model(trainer.state, trainer.method)
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        t1 = time.time()
        run_eval(trainer.eval_step, model, trainer.val_loader, trainer.device)
        torch.cuda.synchronize()
        ev["warm_seconds"] = time.time() - t1
        ev["warm_launches"] = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
        eprof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                   torch.profiler.ProfilerActivity.CUDA])
        eprof.start()
        t1 = time.time()
        run_eval(trainer.eval_step, model, trainer.val_loader, trainer.device)
        torch.cuda.synchronize()
        ev["profiled_wall_ms"] = (time.time() - t1) * 1e3
        eprof.stop()
        ev["prof"] = eprof
        return miou

    trainer.train_step = counted
    trainer.evaluate = counted_eval
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f, a in counters.values():
        setattr(f, a, 0)
    trainer.fit()
    check("train_launches" in ev, f"{label}: fit ran no evaluation")
    launches = ev.get("train_launches", {k: getattr(f, a) for k, (f, a) in counters.items()})
    check(len(losses) == steps, f"{label}: ran {len(losses)} steps, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss {losses}")
    for i, d in enumerate(per_step):
        check(d == expected, f"{label}: step {i} launched {d}, expected {expected}")
    check(all(launches[k] == steps * expected[k] for k in expected),
          f"{label}: launches {launches}")
    peak_gb = ev.get("train_peak_gb", torch.cuda.max_memory_allocated() / 1e9)
    timed = times[warm:steps - profiled]
    ms = statistics.median(timed) * 1e3
    imgs = cfg.train.labeled_batch_size + (cfg.train.unlabeled_batch_size
                                            if trainer.method.uses_unlabeled else 0)
    batch = (f"{cfg.train.labeled_batch_size}+{cfg.train.unlabeled_batch_size}"
             if trainer.method.uses_unlabeled else f"{cfg.train.labeled_batch_size}")
    print(f"[slice] {label} synthetic, {cfg.model.backbone}+{cfg.model.decoder}, "
          f"{cfg.method.name}, {batch} at "
          f"{cfg.data.crop_size}^2, {steps} steps: losses {[round(v, 4) for v in losses]}; "
          f"launches per step {per_step[-1]}; {ms:.1f} ms/step (median of steps "
          f"{warm + 1}-{steps - profiled}) = {imgs / ms * 1e3:.2f} img/s; peak memory "
          f"{peak_gb:.2f} GB ({held_gb:.2f} GB held before the run); step times s "
          f"{[round(t, 3) for t in times]}", flush=True)
    breakdown = device_breakdown(torch, prof, (window[1] - window[0]) * 1e3, profiled)
    record = {"losses": losses, "step_s": times, "ms_per_step": ms,
              "img_per_s": imgs / ms * 1e3, "peak_gb": peak_gb, "held_gb": held_gb,
              "per_step_launches": per_step, "profile": breakdown}

    # ---- the val pass
    eval_launches = ev.get("launches", {k: 0 for k in counters})
    n_val = len(trainer.val_loader.dataset)
    with open(os.path.join(cfg.train.work_dir, "metrics.jsonl")) as f:
        last = json.loads(f.read().strip().splitlines()[-1])
    val = last.get("val", {})
    check(val.get("step") == 0 and math.isfinite(val.get("miou", float("nan"))),
          f"{label}: the val record is missing or its mIoU is not finite: {last}")
    check(eval_launches == eval_expected,
          f"{label}: the val pass launched {eval_launches}, expected {eval_expected}")
    if "prof" in ev:
        check(ev["warm_launches"] == eval_launches,
              f"{label}: the warm val pass launched {ev['warm_launches']}, the first "
              f"{eval_launches}")
        print(f"[slice] {label} eval ({'staged' if use_staged(cfg) else 'fused'} path, "
              f"{n_val} val images at {cfg.data.synthetic_canvas}^2, scales "
              f"{tuple(cfg.data.eval_scales)}, flip {cfg.data.eval_flip}, eval_batch_size "
              f"{cfg.train.eval_batch_size}): mIoU {ev['miou']:.4f}; warm pass "
              f"{ev['warm_seconds']:.3f} s = {n_val / ev['warm_seconds']:.2f} val img/s (the "
              f"first pass, in fit: {ev['seconds']:.3f} s); peak memory {ev['peak_gb']:.2f} GB "
              f"({ev['held_gb']:.2f} GB held before the pass); launches per val pass "
              f"{ {k: v for k, v in eval_launches.items() if v} }", flush=True)
        eb = device_breakdown(torch, ev["prof"], ev["profiled_wall_ms"], 1, unit="pass")
        if eb.get("device_ms_per_step") is not None:
            print(f"[profile] {label} eval: {eb['device_ms_per_step'] / n_val:.1f} device ms "
                  f"per val image", flush=True)
        record["eval"] = {k: v for k, v in ev.items() if k not in ("prof", "train_launches")}
        record["eval"].update({"val_images": n_val, "img_per_s": n_val / ev["warm_seconds"],
                               "first_pass_img_per_s": n_val / ev["seconds"],
                               "launches": eval_launches, "profile": eb, "record": val})
    if after_fit is not None:
        record["after_fit"] = after_fit(torch, trainer, cfg)
    return record, launches, eval_launches


# lower-cased kernel-name fragments -> group, first match wins
GROUPS = [
    ("D at C = 96 (D96 and its weight pack)", ("conv_fwd96_kernel", "pack_w_kernel<96>")),
    ("D at C = 48 (D48 and its weight pack)", ("conv_fwd48_kernel", "pack_w_kernel<48>")),
    ("stem kernels (B, C)", ("stem_fwd_kernel", "stem_dw_kernel", "reduce_partials_kernel")),
    ("branch conv kernels (D's conv_fwd_kernel, E; both D's reduction)",
     ("conv_fwd_kernel", "conv_dw_kernel", "reduce_rows_kernel", "reduce_dk_kernel")),
    ("cutmix kernel (A)", ("_cutmix_normalize_kernel",)),
    ("cuDNN layout transforms", ("nchwtonhwc", "nhwctonchw")),
    ("conv / GEMM (cuDNN, cuBLAS)", ("cudnn", "conv", "xmma", "gemm", "cutlass", "sm90",
                                      "wgrad", "dgrad", "winograd")),
    ("batch norm", ("batch_norm", "batchnorm")),
    ("bilinear resize", ("upsample",)),
    ("memcpy / memset", ("memcpy", "memset")),
    ("reductions", ("reduce",)),
]


def device_breakdown(torch, prof, wall_ms: float, nsteps: int, unit: str = "step") -> dict:
    """Device time per ``unit`` (a step, or a val pass) by kernel group,
    kernel launches per unit and the top kernels, from the profiled window;
    busy share = summed kernel time / window wall time."""
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
           "kernels_per_step": sum(e.count for e in evs) / nsteps,
           "groups_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "top": [{"kernel": e.key[:120], "ms_per_step": e.self_device_time_total / 1e3 / nsteps,
                    "calls_per_step": e.count / nsteps} for e in top]}
    print(f"[profile] {nsteps} profiled {unit}(s): device {dev_ms:.1f} ms/{unit} of "
          f"{wall_ms / nsteps:.1f} ms wall (busy {out['busy_share']:.3f}), "
          f"{out['kernels_per_step']:.0f} kernels per {unit}; by group ms/{unit} "
          f"{ {k: round(v, 2) for k, v in out['groups_ms_per_step'].items()} }", flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['ms_per_step']:8.3f} ms/{unit}  x{t['calls_per_step']:.0f}  "
              f"{t['kernel']}", flush=True)
    return out


if __name__ == "__main__":
    main()
