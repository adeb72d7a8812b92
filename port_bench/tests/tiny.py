"""A copy of the benchmark in a temporary root with tiny cells that run on
the CPU: the configurations cut to 64^2 crops, 2 + 2 images and (HRNet) a
width of 8 with one module a stage, in float32 so that the program and
the reference agree to rounding, and limits of their own."""

from __future__ import annotations

import json
import os
import shutil

from port_bench.bench import ROOT

TINY_LIMITS = {"train": {"loss0_gap": 1e-3, "grad_gap": 0.05, "change_gap": 0.5},
               "eval": {"confusion_gap": 1e-3, "flips_per_near_tie": 1e-2}}
CELLS = {"tiny_r50_train": ("tiny_r50", "tiny_train", "train"),
         "tiny_hrnet_train": ("tiny_hrnet", "tiny_train", "train"),
         "tiny_hrnet_eval": ("tiny_hrnet", "tiny_eval", "eval")}


def _config(root: str, src: str, name: str, **over) -> None:
    with open(os.path.join(ROOT, "port_bench", "configs", src + ".json")) as f:
        c = json.load(f)
    for k, v in over.items():
        sec, field = k.split(".")
        c["config"][sec][field] = v
    c["name"] = name
    with open(os.path.join(root, "port_bench", "configs", name + ".json"), "w") as f:
        json.dump(c, f)


def _write(root: str, sub: str, name: str, obj) -> None:
    with open(os.path.join(root, "port_bench", sub, name + ".json"), "w") as f:
        json.dump(obj, f)


def make_root(root: str) -> str:
    shutil.copytree(os.path.join(ROOT, "port_bench"), os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    small = {"data.crop_size": 64, "train.labeled_batch_size": 2,
             "train.unlabeled_batch_size": 2, "model.compute_dtype": "float32"}
    _config(root, "fixmatch_dlv3p_r50_voc_512", "tiny_r50", **small)
    _config(root, "fixmatch_hrnet_w48_1024", "tiny_hrnet", **small,
            **{"model.hrnet_width": 8, "model.hrnet_modules": [1, 1, 1],
               "method.ohem_min_kept": 1000, "data.eval_stride": 48,
               "data.eval_scales": [0.5, 1.0], "train.eval_batch_size": 2})
    _write(root, "traffic", "tiny_train", {
        "loop": "train", "canvas": [80, 80], "image_sizes": [[80, 60], [60, 80]],
        "label_cell": 8, "ignore_share": 0.1, "labeled_pool": 8, "unlabeled_pool": 8,
        "warm_steps": 1, "trace_steps": 2,
        "state": {"running_stats": "zero_mean", "gain": {"decoder.head.weight": 8.0}}})
    _write(root, "traffic", "tiny_eval", {
        "loop": "eval", "canvas": [64, 128], "image_sizes": [[64, 128]], "label_cell": 8,
        "ignore_share": 0.1, "val_pool": 4, "trace_steps": 1, "check_batches": 1,
        "near_tie": 0.02,
        "state": {"running_stats": "centered", "gain": {"decoder.head.weight": 16.0}}})
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    real = {w["name"]: w for w in bench["workloads"]}
    remap = {"r50_dlv3p_train": "tiny_r50_train", "hrnet_w48_train": "tiny_hrnet_train",
             "hrnet_w48_eval": "tiny_hrnet_eval"}
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                          for n, (c, t, _) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [remap[w] for w in m["workloads"] if w in real]
    for name, (_, _, loop) in CELLS.items():
        _write(root, "limits", name, {k: {"limit": v} for k, v in TINY_LIMITS[loop].items()})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
