"""Centres at data rows drawn uniformly from inside a focus box: users
who look at one part of the map, as in the paper's focused workload
(arXiv 2409.09447, Fig. 8).

The box's side per axis is the traffic file's ``focus_side`` (one number
for every axis, or one per axis).  Its centre, the anchor, is where the
map is densest at the box's size: of ``SAMPLE`` points that the
configuration's generator draws from its ``structure(shape_seed)`` on a
stream of their own, the one whose box holds the most of the others.  It
depends on the map alone, never on ``--seed``: a seed moves the points,
not where users look.
"""
from __future__ import annotations

import importlib

import numpy as np

SAMPLE = 2048
BLOCK = 256
ANCHOR_STREAM = 1  # the points of a run are drawn on stream 0


def anchor(config: dict, side: np.ndarray) -> np.ndarray:
    gen = importlib.import_module(f"portbench.data.{config['generator']}")
    shape = gen.structure(config["shape_seed"], config)
    pts = gen.sample(shape, SAMPLE, [config["shape_seed"], ANCHOR_STREAM])
    held = np.concatenate([
        (np.abs(pts[s:s + BLOCK, None, :] - pts[None]) <= side / 2).all(axis=2).sum(axis=1)
        for s in range(0, SAMPLE, BLOCK)])
    return pts[np.argmax(held)]


def focus_box(spec: dict, config: dict) -> tuple[np.ndarray, np.ndarray]:
    side = np.broadcast_to(np.asarray(spec["focus_side"], dtype=np.float64),
                           (config["d"],))
    a = anchor(config, side)
    return a - side / 2, a + side / 2


def make(spec: dict, points: np.ndarray, config: dict):
    lo, hi = focus_box(spec, config)
    rows = np.flatnonzero(((points >= lo) & (points <= hi)).all(axis=1))
    if not len(rows):
        raise ValueError(f"no data row in the focus box {lo}..{hi}")
    return lambda rng, q: points[rows[rng.integers(0, len(rows), q)]]
