"""Run one cell of the benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the
program.  The run makes its inputs and weights from ``--seed``, builds or
loads the program's kernels (nvcc's libraries in ``build/kernels``,
Triton's cache in ``build/triton``, both inside the checkout), warms up,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which are also the last lines on
standard error.  It exits non-zero and prints no result where the card
is missing, and where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from port_bench import checks  # noqa: E402
from port_bench.bench import ROOT, Benchmark  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "semi_supervised_semantic_segmentation_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that belong to JAX or to the JAX
    package, compared whole (the program's own name starts with the
    package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_environment(root: str) -> None:
    """Caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"


def run_cell(bench: Benchmark, name: str, seed: int, seconds: float, traced: bool,
             device: str, t0: float):
    import torch

    from port_bench.eval_loop import run_eval
    from port_bench.record import Run
    from port_bench.train_loop import run_train

    cell = bench.cell(name)
    run = Run(cell, seed, seconds, traced, device)
    run.device_name = (torch.cuda.get_device_name() if torch.device(device).type == "cuda"
                       else "cpu")
    run.loop = cell.traffic["loop"]
    {"train": run_train, "eval": run_eval}[run.loop](run, t0)
    return run


def result(run) -> dict:
    metrics = {}
    for m in (run.cell.per_layer if run.traced else run.cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    cuda = run.device_name != "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name,
              "count": run.cell.chips if cuda else 1, "memory_peak_bytes": run.peak_bytes}
    held = {**run.checks, "failed": {"value": run.failed, "limit": 0}}
    out = {"correct": checks.correct(held),
           "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.wall_s
        out["breakdown"] = {"device_ops": run.trace.groups(), "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = held
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment(ROOT)
    bench = Benchmark(ROOT)
    chips = bench.cell(args.workload).chips

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    line = result(run)
    print(json.dumps(line), flush=True)
    if run.notes:
        print(f"port_bench: notes {json.dumps(run.notes)}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"port_bench: check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
