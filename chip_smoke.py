#!/usr/bin/env python3
"""Drive the PyTorch port's main and retrieval paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases (any failure exits non-zero; nothing is caught):

1. The card: its name, the device count and ``nvidia-smi``'s name and
   power limit.
2. Build: the CUDA sources under ``src/repro_torch/kernels/csrc/`` compile
   with ``nvcc`` (one process per source, all at once); the ``-Xptxas -v``
   register and spill lines are printed.
3. Main path at d = 2: ``osm_like(10_000_000, seed=7)`` is bulk loaded by
   FMBI on the host, exported to the card plain and compressed, and a
   1024-window batch and a 1024-query k = 16 k-NN batch run on each export.
   The launch counts are zeroed just before and read just after; each of
   the path's four kernels must have launched.  The first 32 windows and the first 16 k-NN
   queries are held against a NumPy brute force over all points (equal id
   sets; equal f32 distance sequences).
4. The same at d = 5 over ``nycyt_like(2_000_000)``, with the windows
   (half-width 0.05) centred at dataset rows so that they hold points.
5. Retrieval at d = 2 (run right after phase 3, while its points and
   index are in memory): ``RetrievalServer(points, levels=15)`` builds the
   balanced grid index on the card over phase 3's points (f32), then runs,
   each cold and warm: ``knn`` over phase 3's 1024 queries (k = 16, 16
   candidate leaves), ``window_count`` over phase 3's 1024 windows,
   ``knn_kernel`` (brute force) over the first 64 queries, an adaptive
   ``knn`` stream (``route`` each batch), ``route`` of every point (FMBI's
   Step-2 shape) and a snapshot boot (phase 3's FMBI index saved, served
   by ``RetrievalServer.from_snapshot``, ``knn`` through
   ``nearest_leaf``).  The counts are zeroed before and read after; each
   of the phase's four kernels must have launched.  Every window count
   must equal phase 3's fused window batch (f32 export), and the first 16
   certified ``knn`` answers and 16 ``knn_kernel`` answers the NumPy brute
   force.
6. The same at d = 5 over phase 4's points and queries, ``levels=13``.
7. Kernels: each kernel is called on the inputs its path gave it (the
   largest call per kernel and bound type for ``box_hits`` and the
   retrieval kernels, the first for the others, recorded during phases 3
   and 5) and held bit for bit against its plain PyTorch version on the
   card; both are timed with CUDA events, and ``pairwise_dist2`` beside
   ``torch.cdist``.  The same comparison runs at d = 5.

``--profile`` adds a ``torch.profiler`` trace of one batch of each kind
per export and of the retrieval ``knn``, ``window_count`` and
``knn_kernel`` batches (device busy time, idle share, time by kernel
name).  The line
before the last is one JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the ``src/`` tree beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
REPO = pathlib.Path(__file__).resolve().parent

REPLACES = {
    "box_hits": ("src/repro_torch/kernels/csrc/window_filter.cu",
                 "src/repro/kernels/window_filter.py:229"),
    "pair_window_ids": ("src/repro_torch/kernels/csrc/window_filter.cu",
                        "src/repro/kernels/window_filter.py:299"),
    "leaf_mindist": ("src/repro_torch/kernels/csrc/knn_topk.cu",
                     "src/repro/kernels/knn_topk.py:142"),
    "pair_dist2": ("src/repro_torch/kernels/csrc/knn_topk.cu",
                   "src/repro/kernels/knn_topk.py:192"),
    "partition_assign": ("src/repro_torch/kernels/csrc/partition_assign.cu",
                         "src/repro/kernels/partition_assign.py:48"),
    "window_count_gathered": ("src/repro_torch/kernels/csrc/window_filter.cu",
                              "src/repro/kernels/window_filter.py:183"),
    "pairwise_dist2": ("src/repro_torch/kernels/csrc/knn_topk.cu",
                       "src/repro/kernels/knn_topk.py:96"),
    "gathered_dist2": ("src/repro_torch/kernels/csrc/knn_topk.cu",
                       "src/repro/kernels/knn_topk.py:59"),
}
MAIN_PATH = ("box_hits", "pair_window_ids", "leaf_mindist", "pair_dist2")
RETRIEVAL = ("partition_assign", "window_count_gathered", "pairwise_dist2",
             "gathered_dist2")
OPS_NAME = {
    "box_hits": "box_hits_tiled",
    "pair_window_ids": "pair_window_ids",
    "leaf_mindist": "leaf_mindist_tiled",
    "pair_dist2": "pair_dist2",
    "partition_assign": "partition_assign",
    "window_count_gathered": "window_count_gathered",
    "pairwise_dist2": "pairwise_dist2",
    "gathered_dist2": "gathered_dist2",
}
# the argument whose dtype keys a recorded call (the bounds or the points)
BOUND_ARG = {"box_hits": 0, "pair_window_ids": 2, "leaf_mindist": 1,
             "pair_dist2": 1, "partition_assign": 0, "window_count_gathered": 2,
             "pairwise_dist2": 1, "gathered_dist2": 1}
LARGEST = ("box_hits",) + RETRIEVAL


def log(*a) -> None:
    print(*a, flush=True)


# --------------------------------------------------------------------------
# recording the main path's kernel inputs
# --------------------------------------------------------------------------
class Recorder:
    """Wraps the public wrappers of ``names`` while a path runs and keeps,
    per kernel and bound dtype, the arguments of one call: the largest for
    ``box_hits`` and the retrieval kernels, the first call (the whole
    batch's first round or first pair chunk) for the others."""

    def __init__(self, ops, names):
        self.ops = ops
        self.names = names
        self.calls: dict = {}
        self._orig = {}

    def __enter__(self):
        for name in self.names:
            fn_name = OPS_NAME[name]
            orig = getattr(self.ops, fn_name)
            self._orig[fn_name] = orig
            setattr(self.ops, fn_name, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for fn_name, orig in self._orig.items():
            setattr(self.ops, fn_name, orig)

    def _wrap(self, name, orig):
        def call(*args, **kw):
            out = orig(*args, **kw)
            first = out[0] if isinstance(out, tuple) else out
            key = (name, str(args[BOUND_ARG[name]].dtype).replace("torch.", ""))
            if key not in self.calls or (
                    name in LARGEST and first.numel() > self.calls[key][2]):
                self.calls[key] = (args, kw, first.numel())
            return out
        return call


# --------------------------------------------------------------------------
# numpy brute force (the reference the sampled results are held against)
# --------------------------------------------------------------------------
def brute_window(pts32, lo, hi) -> np.ndarray:
    inside = np.ones(len(pts32), dtype=bool)
    for k in range(pts32.shape[1]):
        inside &= (pts32[:, k] >= lo[k]) & (pts32[:, k] <= hi[k])
    return np.flatnonzero(inside)


def brute_d2(pts32, q) -> np.ndarray:
    """f32 squared distances summed per dimension in the kernel's order."""
    acc = np.zeros(len(pts32), dtype=np.float32)
    for k in range(pts32.shape[1]):
        diff = pts32[:, k] - q[k]
        acc = acc + diff * diff
    return acc


def check_knn(full, ids, d2, k) -> None:
    """Hold one k-NN answer against the brute-force distances ``full``."""
    n = len(full)
    m = min(k, n)
    if len(ids) != m or len(d2) != m or not np.all(np.isfinite(d2)):
        raise AssertionError(f"k-NN answer of {len(ids)} ids, expected {m} finite")
    part = np.argpartition(full, min(m, n - 1))[: m + 1]
    part = part[np.argsort(full[part], kind="stable")]
    want = full[part]
    if not np.array_equal(d2, want[:m]):
        raise AssertionError(f"k-NN distances differ from brute force: {d2} vs {want[:m]}")
    if not np.array_equal(full[ids], d2):
        raise AssertionError("returned distances are not those of the returned ids")
    if m < n and want[m - 1] < want[m]:  # no tie at the k-th boundary
        if set(ids.tolist()) != set(part[:m].tolist()):
            raise AssertionError("k-NN ids differ from brute force")


# --------------------------------------------------------------------------
# timing one batch
# --------------------------------------------------------------------------
def timed_runs(fn, torch, launches, runs=2):
    """Run ``fn`` ``runs`` times (the first includes one-time set-up);
    returns its last result and ``{"wall_s": [...], "launches": the
    launches of the last run, by kernel}``."""
    times = []
    for _ in range(runs):
        before = launches.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = launches.counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return res, {"wall_s": times, "launches": delta}


# --------------------------------------------------------------------------
# one main-path run
# --------------------------------------------------------------------------
def main_path(tag, pts, seed_q, n_windows, n_knn, k, torch, rt, launches,
              device="cuda", half_width=0.01, at_points=False, profile=False):
    """Bulk load ``pts``, export it plain and compressed, run the window and
    k-NN batches on both with the launch counts zeroed before and read
    after, and check them against the brute force.  Windows of
    ``half_width`` are centred uniformly in [0, 0.9)^d, or at dataset rows
    when ``at_points``; k-NN queries are uniform in [0, 1)^d.  Returns the
    measurements and the recorded kernel calls."""
    from repro_torch.core.pagestore import branch_capacity, leaf_capacity
    from repro_torch.core.queries_torch import _frontier_count
    from repro_torch.kernels import ops

    n, d = pts.shape
    # benchmarks/common.py:buffer_pages, recomputed: 5 % of the data pages
    buffer_pages = max(int(-(-n // leaf_capacity(d)) * 0.05), branch_capacity(d) + 1)
    out = {"n": n, "d": d, "buffer_pages": buffer_pages}
    t0 = time.perf_counter()
    idx = rt.bulk_load(pts, buffer_pages, rt.PageStore(buffer_pages))
    out["bulk_load_s"] = time.perf_counter() - t0
    out["io"] = {"reads": idx.store.stats.reads, "writes": idx.store.stats.writes}
    torch.cuda.reset_peak_memory_stats()
    devs = {}
    for comp in (False, True):
        t0 = time.perf_counter()
        devs[comp] = rt.DeviceTable.from_index(idx, compressed=comp, device=device)
        torch.cuda.synchronize()
        out[f"export_{'bf16' if comp else 'f32'}_s"] = time.perf_counter() - t0
    dev = devs[False]
    out.update(leaves=dev.n_leaves, leaf_size=dev.leaf_size,
               levels=len(dev.levels), live_points=dev.live_points())
    qrng = np.random.default_rng(seed_q)
    if at_points:
        centres = pts[qrng.integers(0, n, n_windows)]
    else:
        centres = qrng.random((n_windows, d)) * 0.9
    los, his = centres - half_width, centres + half_width
    qs = qrng.random((n_knn, d))
    log(f"[{tag}] n={n} d={d} bulk_load {out['bulk_load_s']:.3f} s, "
        f"{dev.n_leaves} leaves of <= {dev.leaf_size} slots, {len(dev.levels)} levels")

    recorder = Recorder(ops, MAIN_PATH)
    launches.reset()
    batches = {}
    with recorder:
        for comp, dv in devs.items():
            name = "bf16" if comp else "f32"
            runs = {"window": lambda: rt.window_query_batch_torch(dv, los, his),
                    "knn": lambda: rt.knn_query_batch_torch(dv, qs, k, return_dists=True)}
            for kind, run in runs.items():
                res, rec = timed_runs(run, torch, launches, runs=3)
                batches[(kind, name)] = res
                if kind == "window":
                    rec["chunks"] = rec["launches"].get("pair_window_ids", 0)
                    rec["ids"] = int(sum(len(r) for r in res))
                else:
                    rec["rounds"] = rec["launches"].get("leaf_mindist", 0)
                out[f"{kind}_{name}"] = rec
                log(f"[{tag}] {kind} batch ({name} bounds): {rec}")
    counts = launches.counts()
    out["launches"] = counts
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    missing = [kk for kk in MAIN_PATH if counts[kk] == 0]
    if missing:
        raise AssertionError(f"[{tag}] kernels not launched on the main path: {missing}")
    log(f"[{tag}] main-path launches {counts}; max_memory_allocated "
        f"{out['max_memory_allocated']} B")

    qlo = torch.from_numpy(los.astype(np.float32)).to(device)
    qhi = torch.from_numpy(his.astype(np.float32)).to(device)
    for comp, dv in devs.items():
        out[f"pairs_{'bf16' if comp else 'f32'}"] = int(_frontier_count(dv, qlo, qhi)[1])

    pts32 = pts.astype(np.float32)
    lo32, hi32, qs32 = los.astype(np.float32), his.astype(np.float32), qs.astype(np.float32)
    for i in range(32):
        want = brute_window(pts32, lo32[i], hi32[i])
        for name in ("f32", "bf16"):
            if not np.array_equal(np.sort(batches[("window", name)][i]), want):
                raise AssertionError(f"[{tag}] window {i} ({name}) differs from brute force")
    for i in range(16):
        full = brute_d2(pts32, qs32[i])
        for name in ("f32", "bf16"):
            ids, d2 = batches[("knn", name)]
            check_knn(full, ids[i], d2[i], k)
    for name in ("f32", "bf16"):
        if (len(batches[("window", name)]), len(batches[("knn", name)][0])) != (
                n_windows, n_knn):
            raise AssertionError(f"[{tag}] a batch lost queries ({name})")
    # every window and k-NN answer: the compressed export equals the plain
    for a, b in zip(batches[("window", "f32")], batches[("window", "bf16")]):
        if not np.array_equal(np.sort(a), np.sort(b)):
            raise AssertionError(f"[{tag}] compressed and plain windows differ")
    for a, b in zip(batches[("knn", "f32")][1], batches[("knn", "bf16")][1]):
        if not np.array_equal(a, b):
            raise AssertionError(f"[{tag}] compressed and plain k-NN distances differ")
    if profile:
        out["profile"] = {
            name: profile_batches({
                "window": lambda: rt.window_query_batch_torch(dv, los, his),
                "knn": lambda: rt.knn_query_batch_torch(dv, qs, k)}, torch)
            for name, dv in (("f32", devs[False]), ("bf16", devs[True]))
        }
        log(f"[{tag}] profile: {out['profile']}")
    log(f"[{tag}] 32 windows and 16 k-NN queries per export equal the brute force")
    inputs = {"index": idx, "los": los, "his": his, "qs": qs,
              "window_counts": np.array([len(r) for r in batches[("window", "f32")]])}
    return out, recorder.calls, inputs


# --------------------------------------------------------------------------
# the retrieval path (balanced grid index + RetrievalServer)
# --------------------------------------------------------------------------
def retrieval_path(tag, pts, inputs, levels, k, torch, rt, launches,
                   n_kernel=64, n_check=16, device="cuda", profile=False):
    """Build ``RetrievalServer(pts, levels)`` on the card, run its batches
    cold and warm with the launch counts zeroed before and read after, and
    check them against phase 3's (or 4's) fused window counts and the
    NumPy brute force.  Returns the measurements and the recorded kernel
    calls."""
    from repro_torch.core import grid_index as GI
    from repro_torch.kernels import ops

    n, d = pts.shape
    pts32 = pts.astype(np.float32)
    lo32 = inputs["los"].astype(np.float32)
    hi32 = inputs["his"].astype(np.float32)
    qs32 = inputs["qs"].astype(np.float32)
    out = {"n": n, "d": d, "levels": levels, "k": k}
    recorder = Recorder(ops, RETRIEVAL)
    launches.reset()
    with recorder:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = rt.RetrievalServer(pts32, levels=levels, device=device)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        index = srv.index
        out.update(leaves=index.n_leaves, leaf_size=index.leaf_size)
        inter, contained = GI._leaf_window_masks(
            index, torch.from_numpy(lo32).to(device), torch.from_numpy(hi32).to(device))
        straddle = (inter & ~contained).sum(dim=1)
        c = GI._pow2(max(int(straddle.max()), 1))
        out["window_budget_c"] = c
        out["straddle_mean"] = float(straddle.float().mean())
        out["gathered_bytes"] = len(lo32) * c * index.leaf_size * (4 * d + 4)
        del inter, contained
        log(f"[{tag}] build {out['build_s']:.3f} s: {index.n_leaves} leaves of "
            f"{index.leaf_size} slots; window budget c = {c} (mean straddle "
            f"{out['straddle_mean']:.1f}), gathered {out['gathered_bytes']} B")

        knn_res, out["knn"] = timed_runs(
            lambda: srv.knn(qs32, k, n_candidate_leaves=16), torch, launches)
        counts, out["window_count"] = timed_runs(
            lambda: GI.window_count(index, lo32, hi32).cpu().numpy(), torch, launches)
        kk_res, out["knn_kernel"] = timed_runs(
            lambda: srv.knn_kernel(qs32[:n_kernel], k), torch, launches)
        srv.adaptive = True
        srng = np.random.default_rng(13)
        stream = [(srng.random((64, d)) * 0.05 + 0.6) for _ in range(16)]
        _, out["adaptive_stream"] = timed_runs(
            lambda: [srv.knn(b, k) for b in stream], torch, launches)
        out["adaptive_stream"].update(hit_rate=srv.stats.hit_rate,
                                      queries=srv.stats.queries)
        pts_dev = torch.from_numpy(pts32).to(device)
        leaf_of, out["route_all"] = timed_runs(lambda: GI.route(index, pts_dev),
                                               torch, launches)
        in_box = ((index.leaf_lo[leaf_of.long()] <= pts_dev)
                  & (pts_dev <= index.leaf_hi[leaf_of.long()])).all(dim=1)
        out["route_all"]["share_in_own_box"] = float(in_box.float().mean())
        del pts_dev, leaf_of, in_box

        snap_dir = REPO / "build" / "chip_smoke"
        snap_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=snap_dir) as tmp:
            path = pathlib.Path(tmp) / "index.npz"
            t0 = time.perf_counter()
            inputs["index"].save(path)
            out["snapshot_save_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            boot = rt.RetrievalServer.from_snapshot(path, adaptive=True, device=device)
            torch.cuda.synchronize()
            out["snapshot_boot_s"] = time.perf_counter() - t0
        snap_res, out["snapshot_knn"] = timed_runs(
            lambda: boot.knn(qs32, k, n_candidate_leaves=16), torch, launches)
        out["snapshot_grid"] = {"leaves": boot.index.n_leaves,
                                "leaf_size": boot.index.leaf_size}
    launched = launches.counts()
    out["launches"] = launched
    missing = [kk for kk in RETRIEVAL if launched[kk] == 0]
    if missing:
        raise AssertionError(f"[{tag}] retrieval kernels not launched: {missing}")
    for name in ("knn", "window_count", "knn_kernel", "adaptive_stream", "route_all",
                 "snapshot_knn"):
        log(f"[{tag}] {name}: {out[name]}")
    log(f"[{tag}] snapshot save {out['snapshot_save_s']:.3f} s, boot "
        f"{out['snapshot_boot_s']:.3f} s ({out['snapshot_grid']}); retrieval "
        f"launches {launched}")

    if counts.shape != (len(lo32),) or not np.array_equal(counts, inputs["window_counts"]):
        bad = np.flatnonzero(counts != inputs["window_counts"])
        raise AssertionError(f"[{tag}] window_count differs from the fused window "
                             f"batch at {len(bad)} windows, first {bad[:5]}")
    rows, d2, exact = knn_res
    out["knn_exact_flags"] = int(exact.sum())
    checked = 0
    for i in np.flatnonzero(exact)[:n_check]:
        check_knn(brute_d2(pts32, qs32[i]), rows[i], d2[i], k)
        checked += 1
    srows, sd2, sexact = snap_res
    out["snapshot_exact_flags"] = int(sexact.sum())
    for i in np.flatnonzero(sexact)[:4]:
        check_knn(brute_d2(pts32, qs32[i]), srows[i], sd2[i], k)
    kidx, kd2 = kk_res
    krows = index.row_ids.cpu().numpy()[kidx]
    for i in range(min(n_check, n_kernel)):
        check_knn(brute_d2(pts32, qs32[i]), krows[i], kd2[i], k)
    if checked < n_check:
        raise AssertionError(f"[{tag}] only {checked} certified k-NN answers")
    log(f"[{tag}] all {len(counts)} window counts equal the fused batch; "
        f"{out['knn_exact_flags']} of {len(qs32)} knn answers certified, the first "
        f"{checked} and {n_check} knn_kernel answers equal the brute force; "
        f"{out['route_all']['share_in_own_box']:.6f} of the points lie in their "
        f"routed leaf's box")
    if profile:
        srv.adaptive = False
        out["profile"] = profile_batches({
            "knn": lambda: srv.knn(qs32, k, n_candidate_leaves=16),
            "window_count": lambda: GI.window_count(index, lo32, hi32).cpu(),
            "knn_kernel": lambda: srv.knn_kernel(qs32[:n_kernel], k)}, torch)
        log(f"[{tag}] profile: {out['profile']}")
    del srv, boot
    return out, recorder.calls


# --------------------------------------------------------------------------
# device busy and idle share of one batch (torch.profiler)
# --------------------------------------------------------------------------
def profile_batches(runs: dict, torch) -> dict:
    """Trace one run of each batch in ``runs`` (name -> callable, after a
    warm-up run) and report, per batch, the host wall time, the device busy
    time (the union of the CUDA kernel and copy intervals in the trace),
    the idle share and the device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for kind, run in runs.items():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        busy, end = 0.0, -1.0
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[kind] = {
            "wall_us": wall_us, "device_busy_us": busy,
            "idle_share": 1.0 - busy / wall_us if wall_us else None,
            "device_events": len(spans),
            "top_us": [[name[:80], us] for name, us in top],
        }
    return out


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------
def byte_and_op_counts(name, args, kw, out, torch):
    """Bytes the function must move (each input read once, each output
    written once, counting what these inputs need) and its operations."""
    if name == "box_hits":
        lo, hi, qlo, qhi = args
        n, d = lo.shape
        nq = qlo.shape[0]
        b = 2 * n * d * lo.element_size() + 2 * nq * d * 4 + n * nq * 4
        return b, 2 * n * nq * d
    if name == "leaf_mindist":
        q, lo, hi = args
        nq, d = q.shape
        n_l = lo.shape[0]
        b = 2 * n_l * d * lo.element_size() + nq * d * 4 + nq * n_l * 4
        return b, 6 * nq * n_l * d
    if name == "pair_window_ids":
        qlo, qhi, llo, lhi, pts, lids, cnt, qi, li, pv = args
        p, (n_l, s, d) = qi.shape[0], pts.shape
        qi64, li64 = qi.long(), li.long()
        box_ok = ((llo[li64] <= qhi[qi64]) & (lhi[li64] >= qlo[qi64])).all(1) & (pv > 0)
        live = torch.where(box_ok, cnt[li64].clamp(max=s), 0)
        leaves = torch.unique(li64[box_ok])
        pts_b = int(cnt[leaves].clamp(max=s).sum()) * d * 4
        ids_b = int(torch.unique(out[0][out[0] >= 0]).numel()) * 4
        boxes = int(torch.unique(li64[pv > 0]).numel()) * (8 * d + 4)
        qb = int(torch.unique(qi64).numel()) * 8 * d
        b = 12 * p + qb + boxes + pts_b + ids_b + p * s * 4 + p * 4
        return b, int(live.sum()) * 2 * d
    if name == "pair_dist2":
        q, pts, cnt, qi, li = args
        p, (n_l, s, d) = qi.shape[0], pts.shape
        li64 = li.long()
        leaves = torch.unique(li64)
        pts_b = int(cnt[leaves].clamp(max=s).sum()) * d * 4
        qb = int(torch.unique(qi.long()).numel()) * 4 * d
        b = 8 * p + qb + leaves.numel() * 4 + pts_b + p * s * 4
        return b, int(cnt[li64].clamp(max=s).sum()) * 3 * d
    if name == "partition_assign":
        pts, sdim, sval = args
        n, d = pts.shape
        levels = kw["levels"]
        # points and leaf ids once, and the table entries a descent can reach
        return n * d * 4 + n * 4 + ((1 << levels) - 1) * 8, n * levels
    if name == "window_count_gathered":
        lo, hi, pts, valid = args
        nq, npp, d = pts.shape
        nv = int((valid > 0).sum())
        return 2 * nq * d * 4 + nq * npp * 4 + nv * d * 4 + nq * 4, nv * 2 * d
    if name == "gathered_dist2":
        q, pts, valid = args
        nq, npp, d = pts.shape
        nv = int((valid > 0).sum())
        return nq * d * 4 + nq * npp * 4 + nv * d * 4 + nq * npp * 4, nv * 3 * d
    if name == "pairwise_dist2":
        q, pts, valid = args
        nq, d = q.shape
        n_p = pts.shape[0]
        nv = int((valid > 0).sum())
        return nq * d * 4 + n_p * 4 + nv * d * 4 + nq * n_p * 4, nq * nv * 3 * d
    raise KeyError(name)


def bitwise_equal(a, b, torch) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def time_ms(fn, reps, torch) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(calls, torch, timed: bool, reps: int = 20) -> dict:
    from repro_torch.kernels import knn_topk, partition_assign, ref, window_filter

    kernel = {"box_hits": window_filter.box_hits,
              "pair_window_ids": window_filter.pair_window_ids,
              "leaf_mindist": knn_topk.leaf_mindist,
              "pair_dist2": knn_topk.pair_dist2,
              "partition_assign": partition_assign.partition_assign,
              "window_count_gathered": window_filter.window_count_gathered,
              "pairwise_dist2": knn_topk.pairwise_dist2,
              "gathered_dist2": knn_topk.gathered_dist2}
    plain = {"box_hits": ref.box_hits_tiled_ref,
             "pair_window_ids": ref.pair_window_ids_ref,
             "leaf_mindist": ref.leaf_mindist_ref,
             "pair_dist2": ref.pair_dist2_ref,
             "partition_assign": ref.partition_assign_ref,
             "window_count_gathered": ref.window_count_gathered_ref,
             "pairwise_dist2": ref.pairwise_dist2_ref,
             "gathered_dist2": ref.gathered_dist2_ref}
    # the nearest single PyTorch call, timed beside the kernel and used
    # nowhere in the port (unsquared and unmasked)
    library = {"pairwise_dist2": lambda q, p, valid: torch.cdist(q, p)}
    res = {}
    for (name, bdtype), (args, kw, _) in sorted(calls.items()):
        got = kernel[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g, w) for g, w in zip(got_t, want_t))
        if not all(bitwise_equal(g, w, torch) for g, w in zip(got_t, want_t)):
            raise AssertionError(f"{name} ({bdtype}) differs from its plain version: "
                                 f"max abs err {err}")
        rec = {"shapes": [list(a.shape) for a in args], "max_abs_err": err, **kw}
        if timed:
            b, ops = byte_and_op_counts(name, args, kw, got_t, torch)
            bytes_ms = b / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            rec.update(
                ms=time_ms(lambda: kernel[name](*args, **kw), reps, torch),
                plain_ms=time_ms(lambda: plain[name](*args, **kw), max(reps // 4, 3),
                                 torch),
                bytes=b, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=(time_ms(lambda: library[name](*args), reps, torch)
                            if name in library else None),
            )
        res[(name, bdtype)] = rec
        log(f"kernel {name} ({bdtype}): bitwise equal to plain; {rec}")
    return res


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write every measurement here as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one batch of each kind with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch as rt
    from repro_torch.core.datasets import nycyt_like, osm_like
    from repro_torch.kernels import build, launches

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    built = build.build_all()
    build_s = next(iter(built.values()))["seconds"]
    log(f"build: {build_s:.2f} s for {len(built)} sources in parallel")
    for name, rec in built.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    results = {"device": kind, "count": count, "nvidia_smi": smi, "build_s": build_s}
    pts = osm_like(10_000_000, seed=7)
    results["d2"], calls2, inputs = main_path("d=2", pts, 11, 1024, 1024, 16, torch,
                                              rt, launches, profile=args.profile)
    results["retrieval_d2"], rcalls2 = retrieval_path("retrieval d=2", pts, inputs, 15,
                                                      16, torch, rt, launches,
                                                      profile=args.profile)
    del pts, inputs
    pts5 = nycyt_like(2_000_000)
    results["d5"], calls5, inputs = main_path("d=5", pts5, 11, 1024, 1024, 16, torch,
                                              rt, launches, half_width=0.05,
                                              at_points=True, profile=args.profile)
    results["retrieval_d5"], rcalls5 = retrieval_path("retrieval d=5", pts5, inputs, 13,
                                                      16, torch, rt, launches,
                                                      profile=args.profile)
    del pts5, inputs

    k2 = kernel_phase({**calls2, **rcalls2}, torch, timed=True)
    kernel_phase({**calls5, **rcalls5}, torch, timed=False)

    line = []
    for name, (source, replaces) in REPLACES.items():
        f32 = k2[(name, "float32")]
        phase = "d2" if name in MAIN_PATH else "retrieval_d2"
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": results[phase]["launches"][name],
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        }
        bf = k2.get((name, "bfloat16"))
        if bf is not None:
            entry["bf16"] = {key: bf[key] for key in
                             ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        line.append(entry)
    results["kernels"] = line
    results["kernel_detail"] = {f"{n}[{b}]": v for (n, b), v in k2.items()}
    results["total_s"] = time.perf_counter() - t_start
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(results, indent=1, default=str))
    log(f"total {results['total_s']:.1f} s")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
