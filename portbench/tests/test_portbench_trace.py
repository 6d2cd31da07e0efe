"""A traced run on the CPU: its per-layer metrics come from the measured
window alone, not from the warm-up before it."""
import io
import json

import pytest

from portbench import harness

SPAN_METRICS = ("engine_ms", "serve_self_ms")

SIZES = {"n_points": 20_000, "queries_per_request": 64}
SECONDS = 0.5


@pytest.mark.parametrize("workload", ["osm2d.window", "nycyt5d.knn"])
def test_span_metrics_cover_the_window_only(workload, tmp_path):
    # the span metrics read in every cell here, also where BENCHMARK.json
    # lists them for other cells only
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS:
            m.pop("workloads", None)
    bench_path = tmp_path / "BENCHMARK.json"
    bench_path.write_text(json.dumps(bench))
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(workload, 2**31 + 31, SECONDS, True, device="cpu", sizes=SIZES,
                           sample=16, bench_path=bench_path, isolation_check=False,
                           stdout=out, stderr=err)
    work = json.loads(out.getvalue().splitlines()[-2][len("work "):])
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["engine_ms"] > 0 and m["serve_self_ms"] >= 0
    # the server's seconds in the window fit into the window, which ends
    # with its last request (the warm-up before it lasts four times longer)
    server_s = (m["engine_ms"] + m["serve_self_ms"]) * work["requests"] / 1e3
    assert server_s <= 1.1 * (SECONDS + work["latency_ms"]["p99"] / 1e3)
    assert harness.WARMUP_SECONDS >= 4 * SECONDS
