"""The benchmark is driven by its files: ``BENCHMARK.json`` keeps to the
contract's shape, every name it gives has its file, and a cell, a
configuration, a traffic mix, a limit or a metric added under a new name
is found with no other file edited."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import pytest

from port_bench.bench import ROOT, Benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_contract_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["port_bench"] and 1 <= spec["run_seconds"] <= 51
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [x["name"] for x in spec["configs"] + spec["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in spec["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in spec["end_to_end"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in e2e and "\n" not in m["layer"] for m in spec["per_layer"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in spec["configs"]:
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))


def test_every_cell_loads_and_metric_units_agree(spec):
    bench = Benchmark(ROOT)
    for w in spec["workloads"]:
        cell = bench.cell(w["name"])
        assert any(m.name == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert m.reader.UNIT == m.unit, m.name


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_without_edits(tmp_path, spec):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(os.path.join(root, "port_bench"))
    pkg = os.path.join(root, "port_bench")
    shutil.copy(os.path.join(pkg, "configs", "fixmatch_dlv3p_r50_voc_512.json"),
                os.path.join(pkg, "configs", "new_config.json"))
    with open(os.path.join(pkg, "traffic", "voc_fixmatch_8p8.json")) as f:
        traffic = json.load(f)
    traffic["labeled_pool"] = 48
    with open(os.path.join(pkg, "traffic", "new_mix.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pkg, "limits", "new_cell.json"), "w") as f:
        json.dump({"loss0_gap": {"limit": 0.5}}, f)
    with open(os.path.join(pkg, "metrics", "new_metric.py"), "w") as f:
        f.write('UNIT = "ms"\n\n\ndef read(run):\n    return 42.0\n')
    spec = json.loads(json.dumps(spec))
    spec["configs"].append({"name": "new_config", "source": "x",
                            "file": "port_bench/configs/new_config.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "new_cell", "config": "new_config",
                              "traffic": "new_mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "x",
                              "moves": "train_img_per_s", "workloads": ["new_cell"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "r50_dlv3p_train" in m["workloads"]:
            m["workloads"].append("new_cell")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    cell = Benchmark(root).cell("new_cell")
    assert cell.traffic["labeled_pool"] == 48 and cell.limits == {"loss0_gap": {"limit": 0.5}}
    assert cell.config["name"] == "fixmatch_dlv3p_r50_voc_512"
    assert [m.name for m in cell.per_layer] == ["new_metric"]
    assert cell.per_layer[0].read(None) == 42.0
    after = _digests(pkg)
    assert all(after[k] == v for k, v in before.items())
