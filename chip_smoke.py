#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                 (from the repository root; needs one CUDA card)
    python3 chip_smoke.py --kernels-only  (phases 1 and 2 for kernels B, C, D and E
                                           only: their checks and times, no ok line)

Phases; any failure exits non-zero and prints no result:
 1. build    -- compile ``csrc/*.cu`` with nvcc for sm_90a (one nvcc per
                source, started together) and print the seconds;
 2. kernels  -- each hand-written kernel against its plain PyTorch version
                on the same inputs, at the shapes its path gives it (A, B, C
                at config 3's, B at both of its batches, B and C also twice
                on the same inputs, bit-equal, with their tile plan and
                registers; D, D's post mode and E at config 5's two
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
 3. reference -- at a small size, on the card (kernels) against the CPU
                (plain versions), from the same weights and inputs: the stem
                segment and one config-3 FixMatch step; an HRModule (branches
                16/32) forward and backward (D's post mode in the
                backward); one config-5 FixMatch step (OHEM, fused branch
                convs, remat 'stages:3') on a width-8 HRNet;
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
                peak memory and a profile.
Then it prints the card's name and power limit, one JSON line of kernel
records, and the ok line.  A longer report goes to
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
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG3 = os.path.join(REPO, "configs", "3_fixmatch_dlv3p_r50_voc_512.yaml")
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
    kernels["stem_fwd"] = stem_rows["B N16"]
    kernels["stem_dw"] = stem_rows["C N16"]

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

    # -------------------------------------------- 3. reference, small size
    report["reference"] = reference_phase(torch, dev)

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
    report["slice_config3"], launches3 = slice_phase(torch, "config 3", CONFIG3, {
        "data.synthetic_canvas": 512, "data.synthetic_size": 48, "data.cutmix_impl": "pallas",
        "model.stem_impl": "pallas"}, counters,
        {**none, "cutmix_normalize": 1, "stem_fwd": 2, "stem_dw": 1}, steps=8)
    # D: 8 modules x 2 eligible branches (48 and 96 ch) x 4 blocks x 2 convs
    # = 128 per forward: teacher 128 + student 128 + stage 3's 4 modules
    # re-run by the checkpoint (64) + the dx convs (128), of which the 64 of
    # the convs with the input transform (each block's second) run in D's
    # post mode; the half of each at C = 96 (branch 1, W = 128) on D96, the
    # other half at C = 48 (branch 0, W = 256) on D48; E: 128.
    report["slice_config5"], launches5 = slice_phase(torch, "config 5", CONFIG5, {
        "data.synthetic_canvas": 1024, "data.synthetic_size": 8,
        "train.labeled_batch_size": 4, "train.unlabeled_batch_size": 4}, counters,
        {**none, "branch_conv_fwd": 448, "branch_conv_dx_post": 64, "branch_conv_fwd_c96": 224,
         "branch_conv_dx_post_c96": 32, "branch_conv_fwd_c48": 224, "branch_conv_dx_post_c48": 32,
         "branch_conv_dw": 128, "branch_conv_dw_async": 128},
        steps=8)
    # conv_fwd_kernel's launches are D's less D96's and D48's: none
    old = launches5["branch_conv_fwd"] - launches5["branch_conv_fwd_c96"] \
        - launches5["branch_conv_fwd_c48"]
    check(old == 0, f"config 5: conv_fwd_kernel launched {old} times, expected none")
    launches = {**launches3, **{k: launches5[k] for k in (
        "branch_conv_fwd_c48", "branch_conv_dx_post_c48", "branch_conv_fwd_c96",
        "branch_conv_dx_post_c96", "branch_conv_dw")}}

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
            "launches": launches[kname], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
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


def stem_kernels(torch, dev, stem, time_ms, bound, bf16_peak, ptxas) -> dict:
    """Kernels B and C at config 3's shapes (k = 7, 512^2): B at N = 8 (the
    teacher's batch) and N = 16 (the student's), C at N = 16.  Each against
    its plain version on the same inputs (y within one bf16 ulp, the
    statistics within 1e-3 of each row's max, dW within 1e-3 of max|dW|),
    twice on the same inputs (bit-equal), with its time, the plain
    version's, the library call's and its bound; the tile plan and the
    registers ptxas gives each kernel."""
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
    h = w_ = 512
    h2, w2 = h // 2, w_ // 2
    wt = torch.randn(64, 3, 7, 7, generator=g, device=dev) * 0.05
    w_hwio = wt.permute(2, 3, 1, 0).contiguous()
    w_bf = wt.to(bf16)
    flops_px = 2.0 * 147 * 64
    for n in (8, 16):
        x = (torch.rand(n, h, w_, 3, generator=g, device=dev) * 4.0 - 2.0).to(bf16)
        yk, sk = stem.stem_fwd_cuda(x, w_hwio)
        yk2, sk2 = stem.stem_fwd_cuda(x, w_hwio)
        torch.cuda.synchronize()
        check(torch.equal(yk, yk2) and torch.equal(sk, sk2),
              f"B N={n}: two launches on the same inputs differ")
        yp, sp = stem.stem_fwd_plain(x, wt)
        err_y = (yk.float() - yp.float()).abs()
        # about one bf16 ulp (2^-8 relative, rounding either way) plus f32
        # summation-order noise near zero
        check(bool((err_y <= 2.0 ** -7 * yp.float().abs() + 1e-4).all()),
              f"B N={n}: y differs from the plain version by {err_y.max().item()}")
        err_s = (sk - sp).abs()
        check(bool((err_s <= 1e-3 * sp.abs().amax(dim=1, keepdim=True)).all()),
              f"B N={n}: stats differ by {err_s.max().item()} (rtol 1e-3 of each row's max)")
        x_nchw = x.permute(0, 3, 1, 2)
        k_b = {
            "ms": time_ms(lambda: stem.stem_fwd_cuda(x, w_hwio)),
            "plain_ms": time_ms(lambda: stem.stem_fwd_plain(x, wt)),
            # the conv alone: F.conv2d does not compute the BN statistics
            "library_ms": time_ms(lambda: F.conv2d(x_nchw, w_bf, stride=2, padding=3)),
        }
        nbytes = x.numel() * 2 + wt.numel() * 4 + yk.numel() * 2 + sk.numel() * 4
        k_b["bound_ms"], k_b["bound_by"] = bound(nbytes, flops_px * n * h2 * w2, bf16_peak)
        k_b["max_abs_err"] = err_y.max().item()
        rows[f"B N{n}"] = k_b
        print(f"[kernel B stem_fwd] N={n} {h}x{w_}: max|dy|={k_b['max_abs_err']:.3g} "
              f"max|dstats|={err_s.max().item():.3g}, two launches bit-equal  kernel "
              f"{k_b['ms']:.4f} ms  plain {k_b['plain_ms']:.3f} ms  F.conv2d "
              f"{k_b['library_ms']:.4f} ms  bound {k_b['bound_ms']:.4f} ms ({k_b['bound_by']})",
              flush=True)
        del yk2, sk2, yp, sp, err_y
    dy = (torch.randn(n, 64, h2, w2, generator=g, device=dev) * 1e-2).to(bf16)
    ds = torch.randn(2, 64, generator=g, device=dev) * 1e-3
    dwk = stem.stem_dw_cuda(x, dy, yk, ds, 7)
    dwk2 = stem.stem_dw_cuda(x, dy, yk, ds, 7)
    torch.cuda.synchronize()
    check(torch.equal(dwk, dwk2), "C: two launches on the same inputs differ")
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
    k_c["bound_ms"], k_c["bound_by"] = bound(nbytes, flops_px * n * h2 * w2, bf16_peak)
    k_c["max_abs_err"] = err_w
    rows["C N16"] = k_c
    print(f"[kernel C stem_dw] N={n} {h}x{w_}: max|ddW|={err_w:.3g} (max|dW| "
          f"{dwp.abs().max().item():.3g}), two launches bit-equal  kernel {k_c['ms']:.4f} ms  "
          f"plain {k_c['plain_ms']:.3f} ms  conv2d_weight {k_c['library_ms']:.4f} ms  bound "
          f"{k_c['bound_ms']:.4f} ms ({k_c['bound_by']})", flush=True)
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


def slice_phase(torch, label: str, config_path: str, overrides: dict, counters: dict,
                expected: dict, steps: int):
    """One config through the Trainer on synthetic data for ``steps`` steps.
    Every launch counter is set to 0 just before and read just after; each
    step must launch each kernel ``expected`` times.  Steps 3..steps-2 are
    timed; the last two run under torch.profiler for the breakdown of device
    time by kernel."""
    from semi_supervised_semantic_segmentation_tpu_torch.config import load_config
    from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer

    warm, profiled = 2, 2
    # what an earlier phase left behind (a trainer in a reference cycle)
    # would count in this run's peak memory: collect it, and report what
    # stays allocated
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    cfg = load_config(config_path, {
        "data.dataset": "synthetic", "data.num_workers": 8, "train.iters_per_epoch": steps,
        "train.epochs": 1, "train.log_interval": 1,
        "train.work_dir": os.path.join(OUT_DIR, f"chip_smoke_{label.replace(' ', '')}"),
        **overrides,
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

    trainer.train_step = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f, a in counters.values():
        setattr(f, a, 0)
    trainer.fit()
    launches = {k: getattr(f, a) for k, (f, a) in counters.items()}
    check(len(losses) == steps, f"{label}: ran {len(losses)} steps, expected {steps}")
    check(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss {losses}")
    for i, d in enumerate(per_step):
        check(d == expected, f"{label}: step {i} launched {d}, expected {expected}")
    check(all(launches[k] == steps * expected[k] for k in expected),
          f"{label}: launches {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = times[warm:steps - profiled]
    ms = statistics.median(timed) * 1e3
    imgs = cfg.train.labeled_batch_size + cfg.train.unlabeled_batch_size
    print(f"[slice] {label} synthetic, {cfg.model.backbone}+{cfg.model.decoder}, "
          f"{cfg.train.labeled_batch_size}+{cfg.train.unlabeled_batch_size} at "
          f"{cfg.data.crop_size}^2, {steps} steps: losses {[round(v, 4) for v in losses]}; "
          f"launches per step {per_step[-1]}; {ms:.1f} ms/step (median of steps "
          f"{warm + 1}-{steps - profiled}) = {imgs / ms * 1e3:.2f} img/s; peak memory "
          f"{peak_gb:.2f} GB ({held_gb:.2f} GB held before the run); step times s "
          f"{[round(t, 3) for t in times]}", flush=True)
    breakdown = device_breakdown(torch, prof, (window[1] - window[0]) * 1e3, profiled)
    return ({"losses": losses, "step_s": times, "ms_per_step": ms,
             "img_per_s": imgs / ms * 1e3, "peak_gb": peak_gb, "held_gb": held_gb,
             "per_step_launches": per_step,
             "profile": breakdown}, launches)


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


def device_breakdown(torch, prof, wall_ms: float, nsteps: int) -> dict:
    """Device time per step by kernel group, kernel launches per step and
    the top kernels, from the profiled window; busy share = summed kernel
    time / window wall time."""
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
    print(f"[profile] {nsteps} profiled steps: device {dev_ms:.1f} ms/step of "
          f"{wall_ms / nsteps:.1f} ms wall (busy {out['busy_share']:.3f}), "
          f"{out['kernels_per_step']:.0f} kernels per step; by group ms/step "
          f"{ {k: round(v, 2) for k, v in out['groups_ms_per_step'].items()} }", flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['ms_per_step']:8.3f} ms/step  x{t['calls_per_step']:.0f}  "
              f"{t['kernel']}", flush=True)
    return out


if __name__ == "__main__":
    main()
