"""The controls of the numbers that decide ``correct``, at a cell's size.

    python3 -m port_bench.control --workload <name> --seeds <n> [<n> ...] [--kinds fp8 ...]

Each control puts the plain reference in the program's place, computed
in float8 (``fp8``: conv operands and outputs in e4m3 with a scale per
tensor, gradients in e5m2; the precision below the configurations'
bfloat16) or with a planted fault (``half_batch``, ``pseudo_shift``,
``grad_double``: :mod:`port_bench.reference.fixmatch`); ``bf16``, the
reference at the configurations' own precision, is the witness of what
bfloat16 alone moves.  It prints, per seed and kind, one JSON line: every number, read
against the float32 reference on the same inputs (the first three
training batches in index order, or the first val batch), then
``checks``, the numbers that the cell holds beside their limits
(``limits/<workload>.json``), and ``correct``, judged as a run of the
cell judges it.  The benchmark's own runs do not run this; its
readings set the upper end of each limit.  It needs the card, as the runs
do.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import checks
from port_bench.bench import ROOT, Benchmark
from port_bench.eval_loop import reference_confusions
from port_bench.reference.layers import ROUNDINGS
from port_bench.train_loop import reference_readings
from port_bench.traffic import make_dataset
from port_bench.weights import cell_state

TRAIN_KINDS = ("fp8", "half_batch", "pseudo_shift", "grad_double")
EVAL_KINDS = ("fp8",)


def train_controls(cell, seed: int, kinds, device: str):
    cfgd = cell.config["config"]
    t, classes = cfgd["train"], cfgd["data"]["num_classes"]
    nl, nu = t["labeled_batch_size"], t["unlabeled_batch_size"]
    lab = make_dataset(cell.traffic, "labeled", classes, seed, device)
    unl = make_dataset(cell.traffic, "unlabeled", classes, seed, device)
    batches = [(lab.assemble(list(range(k * nl, (k + 1) * nl))),
                unl.assemble(list(range(k * nu, (k + 1) * nu)))) for k in range(3)]
    total = t["iters_per_epoch"] * t["epochs"]
    state = cell_state(cell, seed, lab.assemble([0, 1])["image"], device)
    ref = reference_readings(cell, seed, state, total, batches, device)
    for kind in kinds:
        rounding, fault = (kind, None) if kind in ROUNDINGS else ("f32", kind)
        got = reference_readings(cell, seed, state, total, batches, device, rounding, fault)
        yield kind, checks.training_numbers(got, ref)


def eval_controls(cell, seed: int, kinds, device: str):
    cfgd = cell.config["config"]
    val = make_dataset(cell.traffic, "val", cfgd["data"]["num_classes"], seed, device)
    batch = [list(range(cfgd["train"]["eval_batch_size"]))]
    state = cell_state(cell, seed, val.assemble([0, 1])["image"], device)
    ref, ties = reference_confusions(cell, state, val, batch, device)
    for kind in kinds:
        got, _ = reference_confusions(cell, state, val, batch, device, rounding=kind)
        yield kind, checks.eval_numbers(got, ref, val.valid_pixels(batch[0]), ties)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = Benchmark(ROOT).cell(args.workload)
    train = cell.traffic["loop"] == "train"
    kinds = args.kinds or (TRAIN_KINDS if train else EVAL_KINDS)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for kind, numbers in (train_controls if train else eval_controls)(cell, seed, kinds,
                                                                           "cuda"):
            held = checks.held(numbers, cell.limits)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers, "card": torch.cuda.get_device_name(),
                              "seconds": time.perf_counter() - t0, "checks": held,
                              "correct": checks.correct(held)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
