"""What the benchmark loads: a dry run of ``port_bench.run`` on the CPU
at a tiny size loads no module whose whole top-level name is ``jax``,
``jaxlib``, ``flax``, ``optax`` or the JAX package's, and the plain
reference loads nothing of the program.  Each runs in a fresh process,
so that the module table is its own."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from port_bench.bench import ROOT
from port_bench.run import FORBIDDEN

PROGRAM = "semi_supervised_semantic_segmentation_tpu_torch"

DRY_RUN = """
import json, sys, torch
torch.set_num_threads(2)
from port_bench.bench import Benchmark
from port_bench.run import forbidden_modules, result, run_cell
from port_bench.tests import tiny
bench = Benchmark(tiny.make_root(sys.argv[1]))
for cell in sorted(tiny.CELLS):
    result(run_cell(bench, cell, 7, 0.2, True, "cpu", 0.0))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import port_bench.reference.augment, port_bench.reference.evaluate
import port_bench.reference.fixmatch, port_bench.reference.layers, port_bench.reference.models
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_dry_run_loads_no_jax(tmp_path):
    names = _top_level(DRY_RUN, str(tmp_path))
    assert PROGRAM in names
    assert not names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & ({PROGRAM} | set(FORBIDDEN))


def test_reference_sources_import_no_program():
    ref = os.path.join(ROOT, "port_bench", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in {PROGRAM, *FORBIDDEN}, (f, n)
                assert top in {"port_bench", "torch", "math", "copy", "contextlib", "typing",
                               "dataclasses", "__future__"}, (f, n)
