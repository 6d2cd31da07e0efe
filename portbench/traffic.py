"""The one traffic generator: it reads a mix's file ``traffic/<name>.json``
and makes its requests from the run's seed.

Request ``i`` of a stream depends only on the seed, the stream and ``i``,
so any number of requests can be drawn without a pool that a fast run
could exhaust, and two runs of one seed send the same requests.  Every
coordinate is a float32 value (the card serves float32), so the program
and the reference see the same queries.

Sizes follow the paper's query protocol: a window covers ``area_per_n``
/ N of the unit data space (N the points indexed), a cube of half-width
``0.5 * (area_per_n / N) ** (1 / d)``, which holds ``area_per_n`` points
of uniform data.  Kinds:

* ``window``: that cube around each centre;
* ``knn``: a point drawn uniformly from that cube around each centre,
  answered with ``k`` neighbours.

Centres are data rows (``"center": "data_rows"``) drawn uniformly.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

DIR = pathlib.Path(__file__).resolve().parent / "traffic"

WINDOW_STREAM, WARMUP_STREAM, TRACE_STREAM = 0, 1, 2


def load(name: str) -> dict:
    spec = json.loads((DIR / f"{name}.json").read_text())
    if spec["kind"] not in ("window", "knn") or spec["center"] != "data_rows":
        raise ValueError(f"traffic {name}: no generator for {spec}")
    return spec


def _f32(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32).astype(np.float64)


class Traffic:
    def __init__(self, spec: dict, points: np.ndarray, seed: int):
        self.spec = spec
        self.kind = spec["kind"]
        self.q = int(spec["queries_per_request"])
        self.k = int(spec["k"]) if self.kind == "knn" else None
        self.points = points
        self.seed = int(seed) % 2**64
        n, d = points.shape
        self.half_width = 0.5 * (spec["area_per_n"] / n) ** (1.0 / d)

    def request(self, i: int, stream: int = WINDOW_STREAM):
        """``(los, his)`` for a window request, the query points for k-NN."""
        rng = np.random.default_rng([self.seed, 1 + stream, i])
        c = self.points[rng.integers(0, len(self.points), self.q)]
        hw = self.half_width
        if self.kind == "window":
            return _f32(c - hw), _f32(c + hw)
        return _f32(c + rng.uniform(-hw, hw, size=c.shape))

    def query(self, req, j: int):
        """Query ``j`` of a request, as the comparison takes it."""
        if self.kind == "window":
            return req[0][j], req[1][j]
        return req[j]

    def serve(self, srv, req):
        if self.kind == "window":
            return srv.window(*req)
        return srv.knn(req, self.k)
