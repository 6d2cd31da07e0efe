"""Every cell of BENCHMARK.json resolves, by name, to the files it runs
from, and the file keeps the contract's shapes."""
import importlib
import json
import re

import pytest

from portbench import harness, traffic

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["kind"] in ("window", "knn")
    assert cell.limits, "a cell needs the limits of its comparison"
    for kind in ("end_to_end", "per_layer"):
        for m in cell.metrics[kind]:
            assert hasattr(importlib.import_module(f"portbench.metrics.{m['name']}"), "read")
    data = importlib.import_module(f"portbench.data.{cell.config['generator']}")
    assert callable(data.structure) and callable(data.sample)


def test_names_units_and_references():
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    reports = {m["name"]: set(m.get("workloads", CELLS)) for m in BENCH["end_to_end"]}
    assert reports["setup_s"] == set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        # every cell that reads the metric reports the metric it moves
        assert set(m.get("workloads", CELLS)) <= reports[m["moves"]] <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg) and c["file"].startswith("portbench/")
        assert len(c["source"]) <= 200


@pytest.mark.parametrize("name", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_traffic_files_load(name):
    spec = traffic.load(name)
    assert spec["queries_per_request"] > 0 and spec["check_sample"] > 0
