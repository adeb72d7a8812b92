"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, the metrics and
the configurations; every configuration, traffic mix, per-cell limit and
metric is a file of its own under ``port_bench/``:

- ``configs/<config>.json``: the configuration as run (``config``: every
  section of the program's configuration) with its source and cuts;
- ``traffic/<traffic>.json``: the traffic mix that :mod:`port_bench.traffic`
  generates and the loop that drives it (``loop``: ``train`` or ``eval``);
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
- ``metrics/<metric>.py``: the reader of one metric (``read(run)``).

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries, without editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    per_layer: bool
    moves: Optional[str]
    workloads: Optional[List[str]]
    reader: object  # the module of metrics/<name>.py

    def read(self, run) -> Optional[float]:
        return self.reader.read(run)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict  # configs/<config>.json
    traffic: Dict  # traffic/<traffic>.json
    limits: Dict  # limits/<name>.json
    end_to_end: List[Metric]
    per_layer: List[Metric]


class Benchmark:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.pkg = os.path.join(root, "port_bench")
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))

    def file(self, *parts: str) -> str:
        return os.path.join(self.pkg, *parts)

    def _metric(self, entry: Dict, per_layer: bool) -> Metric:
        path = self.file("metrics", entry["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "port_bench_metric_" + entry["name"].replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        if module.UNIT != entry["unit"]:
            raise ValueError(f"{path}: unit {module.UNIT!r}, BENCHMARK.json says {entry['unit']!r}")
        return Metric(entry["name"], entry["unit"], entry["better"], entry["source"], per_layer,
                      entry.get("moves"), entry.get("workloads"), module)

    def cell(self, name: str) -> Cell:
        entries = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = entries[0]
        e2e = [self._metric(m, False) for m in self.spec["end_to_end"]
               if m.get("workloads") is None or name in m["workloads"]]
        names = {m.name for m in e2e}
        per_layer = [self._metric(m, True) for m in self.spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
        config = _load_json(self.file("configs", w["config"] + ".json"))
        traffic = _load_json(self.file("traffic", w["traffic"] + ".json"))
        limits = _load_json(self.file("limits", name + ".json"))
        return Cell(name, w["chips"], w["config"], w["traffic"], config, traffic, limits,
                    e2e, per_layer)
