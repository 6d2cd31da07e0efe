"""The per-layer metrics that read the engine's own counters
(``repro_torch.tracing``): a traced CPU run of each cell that lists them
reports them, and they agree with the work the engine was given; a
program without the counters gives no reading and no error."""
import io
import json
import sys

import pytest

from portbench import harness
from portbench.metrics import knn_rounds_per_request, pair_chunks_per_request

SIZES = {"n_points": 20_000, "queries_per_request": 64}
SECONDS = 0.5
CHUNK = 512     # pairs a chunk, so that a CPU request makes several chunks


def _run(workload, monkeypatch):
    from repro_torch import tracing
    from repro_torch.core import queries_torch

    monkeypatch.setattr(queries_torch, "PAIR_CHUNK", CHUNK)
    tracing.reset()
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(workload, 2**31 + 57, SECONDS, True, device="cpu", sizes=SIZES,
                           sample=16, isolation_check=False, stdout=out, stderr=err)
    work = json.loads(out.getvalue().splitlines()[-2][len("work "):])
    return res, work, tracing.counters()


def test_pair_chunks_per_request_reads_the_engine(monkeypatch):
    res, work, c = _run("nycyt5d.window", monkeypatch)
    assert res["correct"] is True
    chunks = res["metrics"]["pair_chunks_per_request"]["value"]
    assert "knn_rounds_per_request" not in res["metrics"]
    # every request of the process: warm-up, window, traced slice
    assert c["engine.window_batches"] >= work["requests"] + harness.TRACE_REQUESTS
    assert chunks == c["engine.pair_chunks"] / c["engine.window_batches"]
    # a request of p pairs makes ceil(p / CHUNK) chunks; the work line's
    # pairs are the benchmark's own recount over a sample of the window
    pairs = c["engine.pairs"] / c["engine.window_batches"]
    assert pairs / CHUNK <= chunks < pairs / CHUNK + 1
    assert pairs == pytest.approx(work["pairs_per_request"], rel=0.1)


def test_knn_rounds_per_request_reads_the_engine(monkeypatch):
    res, work, c = _run("nycyt5d.knn", monkeypatch)
    assert res["correct"] is True
    rounds = res["metrics"]["knn_rounds_per_request"]["value"]
    assert "pair_chunks_per_request" not in res["metrics"]
    assert c["engine.knn_batches"] >= work["requests"] + harness.TRACE_REQUESTS
    assert rounds == c["engine.knn_rounds"] / c["engine.knn_batches"] >= 1


def test_no_reading_without_the_counters(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)   # import fails
    for metric in (pair_chunks_per_request, knn_rounds_per_request):
        assert metric.read(None) is None
