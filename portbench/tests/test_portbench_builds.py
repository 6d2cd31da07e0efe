"""A configuration names its build and a traffic file its centre kind, and
a cell made of files alone runs: FMBI by default, AMBI's adaptive
deployment under focused traffic from a bench tree outside this one."""
import dataclasses
import io
import json

import pytest
import torch

from portbench import harness
from repro_torch.serve import engine

SIZES = {"n_points": 20_000, "queries_per_request": 256}
SEED = 2**31 + 37


def _bench_tree(tmp_path, build="ambi", center="focused"):
    """A BENCHMARK.json with two AMBI cells under focused traffic, and the
    files they name, under ``tmp_path``."""
    cfg = json.loads((harness.ROOT / "portbench/configs/osm2d-10m.json").read_text())
    cfg.update(name="osm2d-ambi", build=build)
    files = {"portbench/configs/osm2d-ambi.json": cfg}
    for kind, k in (("window", {}), ("knn", {"k": 16})):
        files[f"portbench/traffic/{kind}_focused.json"] = {
            "kind": kind, "center": center, "focus_side": 0.06, "queries_per_request": 1024,
            "area_per_n": 64, "check_sample": 64, **k}
        base = json.loads((harness.ROOT / f"portbench/cells/osm2d.{kind}.json").read_text())
        files[f"portbench/cells/osm2d.ambi_{kind}.json"] = base
    for rel, obj in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(json.dumps(obj))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "osm2d-ambi", "source": "test", "reduced": ["n_points"],
                         "file": "portbench/configs/osm2d-ambi.json", "why": "test"}]
    bench["workloads"] = [{"name": f"osm2d.ambi_{kind}", "config": "osm2d-ambi",
                           "traffic": f"{kind}_focused", "chips": 1, "why": "test"}
                          for kind in ("window", "knn")]
    bench["end_to_end"] = [m for m in bench["end_to_end"]
                           if m["name"] in ("setup_s", "device_bytes_per_point")]
    bench["per_layer"] = []
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path / "BENCHMARK.json"


def test_a_configuration_without_build_deploys_fmbi():
    cell = harness.load_cell("osm2d.window")
    assert "build" not in cell.config
    dep = harness.deploy(cell.config, SEED, "cpu", 64, 5_000)
    assert dep.warmup_requests == 0
    assert type(dep.index).__name__ == "Index" and not dep.server.adaptive
    assert list(dep.setup) == ["data_s", "bulk_load_s", "export_s"]
    assert dep.io_pages > 0


def test_cells_resolve_from_the_bench_tree_they_are_given(tmp_path):
    cell = harness.load_cell("osm2d.ambi_knn", _bench_tree(tmp_path))
    assert cell.config["build"] == "ambi" and cell.traffic["center"] == "focused"
    assert cell.limits == harness.load_cell("osm2d.knn").limits


@pytest.mark.parametrize("what", ["build", "center"])
def test_an_unknown_build_or_centre_names_its_file(tmp_path, what):
    bench = _bench_tree(tmp_path, **{what: "nowhere"})
    rel = ("portbench/configs/osm2d-ambi.json" if what == "build"
           else "portbench/traffic/window_focused.json")
    with pytest.raises(ValueError, match=rel) as info:
        harness.load_cell("osm2d.ambi_window", bench)
    assert "'nowhere'" in str(info.value)


def _held_bytes(dev) -> int:
    """The bytes of the tensors a DeviceTable holds."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            yield x.untyped_storage().nbytes()
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from walk(y)
    return sum(n for f in dataclasses.fields(dev) for n in walk(getattr(dev, f.name)))


@pytest.mark.parametrize("kind", ["window", "knn"])
def test_ambi_under_focused_traffic_runs_from_files(tmp_path, monkeypatch, kind):
    """The card's reading is taken from the index the window serves: on
    the CPU a stand-in counts the bytes of the server's export."""
    servers, boot = [], []
    from_ambi = engine.DeviceQueryServer.from_ambi.__func__

    def booted(cls, ambi, **kw):
        servers.append(from_ambi(cls, ambi, **kw))
        boot.append(_held_bytes(servers[-1].dev))
        return servers[-1]

    monkeypatch.setattr(engine.DeviceQueryServer, "from_ambi", classmethod(booted))
    monkeypatch.setattr(harness, "card_bytes",
                        lambda device: _held_bytes(servers[-1].dev) if servers else 0)
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(f"osm2d.ambi_{kind}", SEED, 0.3, False, device="cpu", sizes=SIZES,
                           sample=48, bench_path=_bench_tree(tmp_path),
                           isolation_check=False, stdout=out, stderr=err)
    work = json.loads(out.getvalue().splitlines()[-2][len("work "):])
    assert res["correct"] is True, err.getvalue()
    assert work["warm_up"]["requests"] == 8 and work["warm_up"]["cold_queries"] > 0
    assert work["warm_up"]["grafts"] > 0
    assert work["server_stats"]["host_fallbacks"] == 0
    assert {"first_request_s", "warmup_requests_s", "boot_s"} <= set(work["setup"])
    start, end = work["card_at_window_start"], work["card_at_window_end"]
    assert 0 < start["leaves"] <= end["leaves"]
    assert work["io_pages_at_window_end"] > work["io_pages"]
    held = res["metrics"]["device_bytes_per_point"]["value"] * SIZES["n_points"]
    assert held > boot[0]
