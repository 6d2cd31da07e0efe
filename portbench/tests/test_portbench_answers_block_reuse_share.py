"""The per-layer metric that reads the window engine's answer hand-off
counters (``repro_torch.tracing``): it gives the share of page-locked
hand-offs that landed in a recycled block, nothing on a CPU run (no
page-locked memory there), and nothing on a program without the
counters."""
import io
import sys

import pytest

from portbench import harness
from portbench.metrics import answers_block_reuse_share

SIZES = {"n_points": 20_000, "queries_per_request": 64}
SECONDS = 0.5


def test_answers_block_reuse_share_reads_the_engine():
    from repro_torch import tracing

    tracing.reset()
    try:
        assert answers_block_reuse_share.read(None) is None     # no counters yet
        tracing.count("engine.answers_pinned", 0)
        tracing.count("engine.answers_fresh_blocks", 0)
        assert answers_block_reuse_share.read(None) is None     # none pinned
        tracing.count("engine.answers_pinned", 50)
        tracing.count("engine.answers_fresh_blocks", 2)
        assert answers_block_reuse_share.read(None) == pytest.approx(96.0)
    finally:
        tracing.reset()


def test_a_cpu_run_gives_no_reading():
    from repro_torch import tracing

    tracing.reset()
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell("nycyt5d.window", 2**31 + 59, SECONDS, True, device="cpu",
                           sizes=SIZES, sample=16, isolation_check=False,
                           stdout=out, stderr=err)
    c = tracing.counters()
    assert res["correct"] is True
    assert c["engine.window_batches"] >= harness.TRACE_REQUESTS
    # a CPU export hands its answers off in pageable memory
    assert c.get("engine.answers_pinned", 0) == 0
    assert "answers_block_reuse_share" not in res["metrics"]


def test_no_reading_without_the_counters(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)   # import fails
    assert answers_block_reuse_share.read(None) is None
