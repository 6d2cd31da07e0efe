#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

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
   The launch counts are zeroed just before and read just after; every
   kernel must have launched.  The first 32 windows and the first 16 k-NN
   queries are held against a NumPy brute force over all points (equal id
   sets; equal f32 distance sequences).
4. The same at d = 5 over ``nycyt_like(2_000_000)``, with the windows
   (half-width 0.05) centred at dataset rows so that they hold points.
5. Kernels: each kernel is called on the inputs the main path gave it (the
   largest call per kernel and bound type, recorded during phase 3) and
   held bit for bit against its plain PyTorch version on the card; both
   are timed with CUDA events.  The same comparison runs at d = 5.

``--profile`` adds a ``torch.profiler`` trace of one batch of each kind
per export (device busy time, idle share, time by kernel name).  The line
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
}
OPS_NAME = {
    "box_hits": "box_hits_tiled",
    "pair_window_ids": "pair_window_ids",
    "leaf_mindist": "leaf_mindist_tiled",
    "pair_dist2": "pair_dist2",
}


def log(*a) -> None:
    print(*a, flush=True)


# --------------------------------------------------------------------------
# recording the main path's kernel inputs
# --------------------------------------------------------------------------
class Recorder:
    """Wraps the public kernel wrappers while the main path runs and keeps,
    per kernel and bound dtype, the arguments of one call: the largest
    level block for ``box_hits``, the first call (the whole batch's first
    round or first pair chunk) for the others."""

    def __init__(self, ops):
        self.ops = ops
        self.calls: dict = {}
        self._orig = {}

    def __enter__(self):
        for name, fn_name in OPS_NAME.items():
            orig = getattr(self.ops, fn_name)
            self._orig[fn_name] = orig
            setattr(self.ops, fn_name, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for fn_name, orig in self._orig.items():
            setattr(self.ops, fn_name, orig)

    def _wrap(self, name, orig):
        def call(*args):
            out = orig(*args)
            first = out[0] if isinstance(out, tuple) else out
            bounds = args[2] if name == "pair_window_ids" else args[0 if name == "box_hits" else 1]
            key = (name, str(bounds.dtype).replace("torch.", ""))
            if key not in self.calls or (
                    name == "box_hits" and first.numel() > self.calls[key][1]):
                self.calls[key] = (args, first.numel())
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

    recorder = Recorder(ops)
    launches.reset()
    batches = {}
    with recorder:
        for comp, dv in devs.items():
            name = "bf16" if comp else "f32"
            for kind in ("window", "knn"):
                times = []
                for _ in range(3):  # the first run includes one-time set-up
                    before = launches.counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if kind == "window":
                        res = rt.window_query_batch_torch(dv, los, his)
                    else:
                        res = rt.knn_query_batch_torch(dv, qs, k, return_dists=True)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    after = launches.counts()
                batches[(kind, name)] = res
                delta = {kk: after[kk] - before[kk] for kk in after}
                rec = {"wall_s": times, "launches": delta}
                if kind == "window":
                    rec["chunks"] = delta["pair_window_ids"]
                    rec["ids"] = int(sum(len(r) for r in res))
                else:
                    rec["rounds"] = delta["leaf_mindist"]
                out[f"{kind}_{name}"] = rec
                log(f"[{tag}] {kind} batch ({name} bounds): wall {times} s, launches {delta}")
    counts = launches.counts()
    out["launches"] = counts
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    missing = [kk for kk, v in counts.items() if v == 0]
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
            name: profile_batches(dv, los, his, qs, k, torch, rt)
            for name, dv in (("f32", devs[False]), ("bf16", devs[True]))
        }
        log(f"[{tag}] profile: {out['profile']}")
    log(f"[{tag}] 32 windows and 16 k-NN queries per export equal the brute force")
    return out, recorder.calls


# --------------------------------------------------------------------------
# device busy and idle share of one batch (torch.profiler)
# --------------------------------------------------------------------------
def profile_batches(dev, los, his, qs, k, torch, rt) -> dict:
    """Trace one window batch and one k-NN batch (after warm-up runs) and
    report, per batch, the host wall time, the device busy time (the union
    of the CUDA kernel and copy intervals in the trace), the idle share and
    the device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for kind in ("window", "knn"):
        def run():
            if kind == "window":
                rt.window_query_batch_torch(dev, los, his)
            else:
                rt.knn_query_batch_torch(dev, qs, k)
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
def byte_and_op_counts(name, args, out, torch):
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
    from repro_torch.kernels import knn_topk, ref, window_filter

    kernel = {"box_hits": window_filter.box_hits,
              "pair_window_ids": window_filter.pair_window_ids,
              "leaf_mindist": knn_topk.leaf_mindist,
              "pair_dist2": knn_topk.pair_dist2}
    plain = {"box_hits": ref.box_hits_tiled_ref,
             "pair_window_ids": ref.pair_window_ids_ref,
             "leaf_mindist": ref.leaf_mindist_ref,
             "pair_dist2": ref.pair_dist2_ref}
    res = {}
    for (name, bdtype), (args, _) in sorted(calls.items()):
        got = kernel[name](*args)
        want = plain[name](*args)
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g, w) for g, w in zip(got_t, want_t))
        if not all(bitwise_equal(g, w, torch) for g, w in zip(got_t, want_t)):
            raise AssertionError(f"{name} ({bdtype}) differs from its plain version: "
                                 f"max abs err {err}")
        rec = {"shapes": [list(a.shape) for a in args], "max_abs_err": err}
        if timed:
            b, ops = byte_and_op_counts(name, args, got_t, torch)
            bytes_ms = b / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            rec.update(
                ms=time_ms(lambda: kernel[name](*args), reps, torch),
                plain_ms=time_ms(lambda: plain[name](*args), max(reps // 4, 3), torch),
                bytes=b, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
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
    results["d2"], calls2 = main_path("d=2", pts, 11, 1024, 1024, 16, torch, rt,
                                      launches, profile=args.profile)
    del pts
    pts5 = nycyt_like(2_000_000)
    results["d5"], calls5 = main_path("d=5", pts5, 11, 1024, 1024, 16, torch, rt,
                                      launches, half_width=0.05, at_points=True,
                                      profile=args.profile)
    del pts5

    k2 = kernel_phase(calls2, torch, timed=True)
    kernel_phase(calls5, torch, timed=False)

    line = []
    for name, (source, replaces) in REPLACES.items():
        f32 = k2[(name, "float32")]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": results["d2"]["launches"][name],
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": None,
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
