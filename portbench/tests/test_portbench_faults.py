"""A whole run on the CPU, with the timed path broken underneath, comes
out not correct: once for each fault a serving cell can have."""
import io

import numpy as np
import pytest

from portbench import harness
from repro_torch.serve import engine

SIZES = {"n_points": 20_000, "queries_per_request": 64}


def _half_left_out(fn):
    def call(*a, **kw):
        out = fn(*a, **kw)
        res = out[0] if isinstance(out, tuple) else out
        for j in range(len(res) // 2, len(res)):
            res[j] = res[j][:0]
        return out
    return call


def _batch_truncated(fn):
    """Half of the batch left out: the engine returns answers for the
    first half of its queries only."""
    def call(*a, **kw):
        out = fn(*a, **kw)
        if isinstance(out, tuple):
            return (out[0][:len(out[0]) // 2],) + tuple(out[1:])
        return out[:len(out) // 2]
    return call


def _answer_altered(fn):
    def call(*a, **kw):
        out = fn(*a, **kw)
        res = out[0] if isinstance(out, tuple) else out
        for j, r in enumerate(res):
            if len(r):
                res[j] = np.concatenate([r[:-1], [(r[-1] + 1) % 20_000]])
        return out
    return call


def _state_unchanged(fn):
    """Each batch answered with the first batch's answers."""
    first = []

    def call(*a, **kw):
        out = fn(*a, **kw)
        if not first:
            first.append(out)
        return first[0]
    return call


FAULTS = {"half_left_out": _half_left_out, "batch_truncated": _batch_truncated,
          "answer_altered": _answer_altered,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["osm2d.window", "nycyt5d.knn"])
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    for name in ("window_query_batch_torch", "knn_query_batch_torch"):
        monkeypatch.setattr(engine, name, FAULTS[fault](getattr(engine, name)))
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(workload, 2**31 + 29, 0.3, False, device="cpu", sizes=SIZES,
                           sample=48, isolation_check=False, stdout=out, stderr=err)
    assert res["correct"] is False
    assert err.getvalue().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload", ["osm2d.window", "nycyt5d.knn"])
def test_the_unbroken_path_is_correct(workload):
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(workload, 2**31 + 29, 0.3, False, device="cpu", sizes=SIZES,
                           sample=48, isolation_check=False, stdout=out, stderr=err)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert out.getvalue().splitlines()[-2].startswith("work ")
