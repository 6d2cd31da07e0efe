"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

The cell's name leads to everything it needs through ``BENCHMARK.json``:
its configuration's file, ``traffic/<traffic>.json`` (read by
``traffic.py``), ``cells/<workload>.json`` (the limits of the comparison)
and one reader per metric under ``metrics/``.  The configuration names its
build (``builds/<build>.py``, FMBI by default) and the traffic file where
its queries fall (``centers/<center>.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import pathlib
import sys
import time

import numpy as np
import torch

from . import builds, bytemodel, compare, isolation, plugins, trace, traffic

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent

WARMUP_SECONDS = 2.0    # before the window, from a stream of their own
TRACE_LEAD = 2          # profiled but outside the traced range
TRACE_REQUESTS = 48     # the traced range, after the window
PAIR_SAMPLE = 64        # window requests whose pairs the work summary counts
KERNEL_SPANS = ("box_hits_tiled", "pair_window_ids", "leaf_mindist_tiled", "pair_dist2")
# what a build that refines while it serves did in the warm-up's first requests
REFINEMENT_STATS = ("cold_queries", "hot_queries", "grafts", "delta_refreshes", "compactions")


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    metrics: dict      # "end_to_end" / "per_layer": the entries that apply


def load_cell(name: str, bench_path: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``bench_path`` (this tree's ``BENCHMARK.json``
    unless given).  Its configuration, ``cells/`` and ``traffic/`` files
    come from the tree that holds ``bench_path``, each one that tree lacks
    from this one."""
    bench_path = bench_path or ROOT / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())

    def find(rel: str) -> pathlib.Path:
        path = bench_path.parent / rel
        return path if path.is_file() else ROOT / rel

    (work,) = [w for w in bench["workloads"] if w["name"] == name]
    (cfg,) = [c for c in bench["configs"] if c["name"] == work["config"]]
    config_path = find(cfg["file"])
    config = json.loads(config_path.read_text())
    plugins.find("builds", config.get("build", builds.DEFAULT), config_path)
    cell_file = json.loads(find(f"portbench/cells/{name}.json").read_text())
    applies = lambda m: name in m.get("workloads", [name])
    return Cell(
        workload=work,
        config=config,
        traffic=traffic.load(work["traffic"], find(f"portbench/traffic/{work['traffic']}.json")),
        limits=cell_file["limits"],
        metrics={kind: [m for m in bench[kind] if applies(m)]
                 for kind in ("end_to_end", "per_layer")},
    )


def make_points(config: dict, seed: int, n: int | None = None) -> np.ndarray:
    """The deployment's points for ``seed``, rounded to float32 values (the
    card holds float32), as float64."""
    gen = importlib.import_module(f"portbench.data.{config['generator']}")
    shape = gen.structure(config["shape_seed"], config)
    pts = gen.sample(shape, n or config["n_points"], [int(seed) % 2**64, 0])
    return pts.astype(np.float32).astype(np.float64)


def buffer_pages(config: dict, n: int) -> int:
    """The FMBI buffer: ``buffer_share`` of the data pages, and at least one
    more page than a branch holds."""
    d, page = config["d"], config["page_size"]
    leaf_cap = page // (4 * d + 4)
    branch_cap = page // (2 * 4 * d + 4)
    return max(int(-(-n // leaf_cap) * config["buffer_share"]), branch_cap + 1)


class Reservoir:
    """A uniform sample of ``size`` (query, answer) pairs over every answer
    of the window, drawn from the seed (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: list = []
        self.seen = 0
        self.rng = np.random.default_rng([int(seed) % 2**64, 9])

    def offer(self, tr: traffic.Traffic, req, answers) -> None:
        n = len(answers)
        t = self.seen + np.arange(n)
        take = (t < self.size) | (self.rng.random(n) * (t + 1) < self.size)
        for j in np.flatnonzero(take):
            q = tr.query(req, j)
            q = tuple(np.array(x) for x in q) if isinstance(q, tuple) else np.array(q)
            item = (q, np.array(answers[j], copy=True))
            if len(self.items) < self.size:
                self.items.append(item)
            else:
                self.items[self.rng.integers(self.size)] = item
        self.seen += n


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    n_points: int
    setup_s: float
    setup: dict
    io_pages: int
    device_bytes: int | None
    device_kind: str
    requests: int = 0
    queries: int = 0
    window_s: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    spans: dict | None = None
    trace: dict | None = None
    traced_requests: int = 0
    kernel_bytes: dict | None = None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_bytes(device) -> int | None:
    """``torch.cuda.memory_allocated()`` once the card is idle; None off
    the card."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _install_spans(spans: trace.Spans, rt) -> None:
    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    for attr in ("window", "knn"):
        spans.wrap(rt.DeviceQueryServer, attr, "server")
    for attr in ("window_query_batch_torch", "knn_query_batch_torch"):
        spans.wrap(engine, attr, "engine")
    for attr in KERNEL_SPANS:
        spans.wrap(ops, attr, f"kernels.{attr}")


def _index_sizes(srv) -> dict | None:
    """The exported index's live sizes: leaf boxes and fills, node count."""
    dev = getattr(srv, "dev", None)
    try:
        return {"leaf_lo": dev.leaf_lo, "leaf_hi": dev.leaf_hi,
                "counts": dev.leaf_counts.long(), "n_nodes": int(srv.table.n_nodes)}
    except AttributeError:
        return None


def _on_card(srv) -> dict:
    """The leaves and cold (unrefined) rows of the server's export."""
    return {"leaves": srv.dev.n_leaves, "cold_rows": srv.dev.n_cold}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _kernel_bytes(tr: traffic.Traffic, sizes: dict, traced: list, points: np.ndarray,
                  d: int) -> dict:
    """The frozen byte model summed over the traced requests."""
    lo, hi, counts = sizes["leaf_lo"], sizes["leaf_hi"], sizes["counts"]
    out = dict.fromkeys(("box_hits", "pair_window_ids", "leaf_mindist", "pair_dist2"), 0)
    for req, answers in traced:
        if tr.kind == "window":
            hit = bytemodel.intersecting(lo, hi, _tensor(req[0], lo.device),
                                         _tensor(req[1], lo.device))
            ids = sum(len(a) for a in answers)
            out["box_hits"] += bytemodel.box_hits(sizes["n_nodes"], d, tr.q)
            out["pair_window_ids"] += bytemodel.pair_window_ids(hit, counts, d, ids)
        else:
            qs = _tensor(req, lo.device)
            kth = torch.from_numpy(np.array([((points[np.asarray(a)] - q) ** 2).sum(axis=1).max()
                                             for q, a in zip(req, answers)])).to(lo.device)
            need = bytemodel.mindist2(lo, hi, qs) <= kth[:, None]
            out["leaf_mindist"] += bytemodel.leaf_mindist(lo.shape[0], d, tr.q)
            out["pair_dist2"] += bytemodel.pair_dist2(need, counts, d)
    return {k: v for k, v in out.items() if v}


@dataclasses.dataclass(kw_only=True)
class Deployment(builds.Built):
    points: np.ndarray
    io_pages: int          # the store's page I/O when the build is done
    warmup_requests: int   # the build's WARMUP_REQUESTS


def _io_pages(store) -> int:
    return store.stats.reads + store.stats.writes


def deploy(cfg: dict, seed: int, device, microbatch: int, n_points: int | None = None) -> Deployment:
    """Make the points and build the index that the configuration names
    (``builds/<build>.py``) behind a ``DeviceQueryServer`` on ``device``;
    each step timed."""
    build = plugins.find("builds", cfg.get("build", builds.DEFAULT),
                         f"configuration {cfg.get('name')}")
    t = time.perf_counter()
    pts = make_points(cfg, seed, n_points)
    data_s = time.perf_counter() - t
    b = build.deploy(cfg, pts, device, microbatch)
    b.setup = {"data_s": data_s, **b.setup}
    return Deployment(**vars(b), points=pts, io_pages=_io_pages(b.store),
                      warmup_requests=build.WARMUP_REQUESTS)


def warm_up_fixed(srv, tr: traffic.Traffic, device, count: int) -> list[float]:
    """Serve the warm-up stream's first ``count`` requests, for a build
    that refines while it serves; each one's seconds."""
    seconds = []
    for i in range(count):
        t = time.perf_counter()
        tr.serve(srv, tr.request(i, traffic.WARMUP_STREAM))
        sync(device)
        seconds.append(time.perf_counter() - t)
    return seconds


def warm_up(srv, tr: traffic.Traffic, device, start: int = 0) -> float:
    """Serve this cell's batch shape from a stream of its own, from its
    request ``start`` on, for ``WARMUP_SECONDS`` (the first runs of a
    request shape are slower on the card than later ones); seconds."""
    t = time.perf_counter()
    i = start
    while time.perf_counter() - t < WARMUP_SECONDS:
        tr.serve(srv, tr.request(i, traffic.WARMUP_STREAM))
        i += 1
    sync(device)
    return time.perf_counter() - t


@dataclasses.dataclass
class Window:
    t0: float
    window_s: float
    latencies: list
    ids_returned: int
    failed: int
    short: int         # requests answered with another count of answers than queries


def measure(srv, tr: traffic.Traffic, seconds: float, reservoir: Reservoir, stderr) -> Window:
    """The measured window: one client, each request sent when the last
    returned, until ``seconds`` have passed."""
    t0 = time.perf_counter()
    t_end = t0 + seconds
    latencies, ids_returned, failed, short, last = [], 0, 0, 0, t0
    i = 0
    while last < t_end:
        req = tr.request(i)
        ts = time.perf_counter()
        try:
            answers = tr.serve(srv, req)
        except Exception as exc:  # a request that raised counts as failed
            print(f"request {i} raised {exc!r}", file=stderr)
            failed += 1
            last = time.perf_counter()
            break
        last = time.perf_counter()
        latencies.append(last - ts)
        short += len(answers) != tr.q
        ids_returned += sum(len(a) for a in answers)
        reservoir.offer(tr, req, answers)
        i += 1
    return Window(t0, last - t0, latencies, ids_returned, failed, short)


def traced_slice(srv, tr: traffic.Traffic, device):
    """Serve ``TRACE_REQUESTS`` more requests under ``torch.profiler``;
    returns the profiler and the requests with their answers."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    served = []
    with torch.profiler.profile(activities=acts) as prof:
        for j in range(TRACE_LEAD):
            tr.serve(srv, tr.request(j, traffic.TRACE_STREAM))
        with torch.profiler.record_function(trace.TRACED):
            for j in range(TRACE_LEAD, TRACE_LEAD + TRACE_REQUESTS):
                req = tr.request(j, traffic.TRACE_STREAM)
                served.append((req, tr.serve(srv, req)))
            sync(device)
    return prof, served


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t_start: float | None = None,
             sizes: dict | None = None, sample: int | None = None,
             bench_path: pathlib.Path | None = None, isolation_check: bool = True,
             stdout=None, stderr=None) -> dict:
    """Run one cell once and print its work line and result line; returns
    the result.  ``sizes`` (``n_points``, ``queries_per_request``) and
    ``sample`` shrink a run for the CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    import repro_torch as rt
    from repro_torch.kernels import launches

    t_imported = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.empty(1, device=device)
        torch.cuda.synchronize()
    t_cuda = time.perf_counter()
    cell = load_cell(workload, bench_path)
    cfg, spec = cell.config, dict(cell.traffic)
    sizes = sizes or {}
    if "queries_per_request" in sizes:
        spec["queries_per_request"] = sizes["queries_per_request"]
    dep = deploy(cfg, seed, device, spec["queries_per_request"], sizes.get("n_points"))
    srv, pts = dep.server, dep.points
    setup = {"imports_s": t_imported - t_start, "cuda_init_s": t_cuda - t_imported, **dep.setup}
    tr = traffic.Traffic(spec, pts, seed, cfg)
    spans = trace.Spans() if traced else None
    if traced:
        _install_spans(spans, rt)
    refines = dep.warmup_requests > 0
    if refines:
        stats0 = dataclasses.asdict(srv.stats)
        first = warm_up_fixed(srv, tr, device, dep.warmup_requests)
        setup["first_request_s"], setup["warmup_requests_s"] = first[0], sum(first[1:])
        stats = dataclasses.asdict(srv.stats)
        warmed = {"requests": len(first), "request_s": first,
                  **{k: stats[k] - stats0[k] for k in REFINEMENT_STATS}}
    setup["warmup_s"] = warm_up(srv, tr, device, dep.warmup_requests)
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    setup["gc_s"] = time.perf_counter() - t
    if dep.device_bytes is None and dep.bytes_before is not None:
        dep.device_bytes = card_bytes(device) - dep.bytes_before
    card_at_start = _on_card(srv) if refines else None
    reservoir = Reservoir(sample or spec["check_sample"], seed)
    launches.reset()
    stats0 = dataclasses.asdict(srv.stats)
    # the warm-up's calls are in the span totals too: count from here
    spans0 = {name: spans.seconds(name) for name in ("server", "engine")} if traced else None
    win = measure(srv, tr, seconds, reservoir, stderr)
    setup_s = win.t0 - t_start
    if refines:
        card_at_end, io_at_end = _on_card(srv), _io_pages(dep.store)
    requests, failed = len(win.latencies), win.failed
    window_spans = None
    if traced:
        window_spans = {name: spans.seconds(name) - t for name, t in spans0.items()}
    counts = launches.counts()
    stats = dataclasses.asdict(srv.stats)
    stats = {k: v - stats0[k] if k != "shards" else v for k, v in stats.items()}

    red, kernel_bytes = None, None
    if traced:
        prof, served = traced_slice(srv, tr, device)
        spans.restore()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    sizes_idx = _index_sizes(srv)
    if traced:
        red = trace.reduce(prof)
        if sizes_idx is not None:
            kernel_bytes = _kernel_bytes(tr, sizes_idx, served, pts, cfg["d"])
        del prof, served
    work = {
        "requests": requests, "queries": requests * tr.q, "failed_requests": failed,
        "short_requests": win.short,
        "ids_returned_per_request": win.ids_returned / requests if requests else None,
        "selectivity": win.ids_returned / (requests * tr.q * len(pts)) if requests else None,
        "half_width": tr.half_width,
        "launches_per_request": {k: v / requests for k, v in counts.items() if v} if requests else {},
        "latency_ms": {f"p{q}": float(np.percentile(win.latencies, q)) * 1e3
                       for q in (5, 25, 50, 75, 95, 99)} if requests else {},
        "requests_by_second": np.bincount(
            (np.cumsum(win.latencies) // 1).astype(int)).tolist() if requests else [],
        "server_stats": stats,
        "setup": {**setup, "other_s": setup_s - sum(setup.values())},
        "points": len(pts), "buffer_pages": dep.buffer_pages, "io_pages": dep.io_pages,
    }
    if refines:
        work.update(warm_up=warmed, card_at_window_start=card_at_start,
                    card_at_window_end=card_at_end, io_pages_at_window_end=io_at_end)
    if sizes_idx is not None:
        work["leaves"] = int(sizes_idx["leaf_lo"].shape[0])
        work["nodes"] = sizes_idx["n_nodes"]
        if tr.kind == "window" and requests:
            picks = np.unique(np.linspace(0, requests - 1, min(PAIR_SAMPLE, requests)).astype(int))
            pairs = [int(bytemodel.intersecting(
                sizes_idx["leaf_lo"], sizes_idx["leaf_hi"],
                *(_tensor(x, device) for x in tr.request(int(p)))).sum()) for p in picks]
            work["pairs_per_request"] = float(np.mean(pairs))

    io_pages, device_bytes = dep.io_pages, dep.device_bytes
    # the program's state goes before the reference runs
    del srv, dep, sizes_idx
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    points_dev = torch.from_numpy(pts).to(device)
    numbers = compare.readings(tr.kind, points_dev, reservoir.items, tr.k)
    numbers["faults"] = stats["retries"] + stats["host_fallbacks"] + stats["degraded_queries"]
    numbers["failed_requests"] = failed
    numbers["short_requests"] = win.short
    numbers["sampled_answers"] = len(reservoir.items)
    ok, checks = compare.judge(numbers, cell.limits)
    ok = ok and requests > 0 and len(reservoir.items) > 0

    r = Run(n_points=len(pts), setup_s=setup_s, setup=setup, io_pages=io_pages,
            device_bytes=device_bytes,
            device_kind=torch.cuda.get_device_name(0) if on_card else "cpu",
            requests=requests, queries=requests * tr.q, window_s=win.window_s,
            latencies=win.latencies, spans=window_spans, trace=red,
            traced_requests=TRACE_REQUESTS if red else 0, kernel_bytes=kernel_bytes)
    metrics = {}
    for m in cell.metrics["per_layer" if traced else "end_to_end"]:
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": bool(ok),
        "attempted": requests * tr.q,
        "failed": failed * tr.q,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": r.device_kind,
                   "count": 1 if on_card else 0, "memory_peak_bytes": int(memory_peak)},
    }
    if traced and red is not None:
        result["device"].update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = red["breakdown"]
    result["checks"] = checks

    found = isolation.forbidden_loaded() if isolation_check else []
    if found:
        print(f"portbench: the run loaded {found}; no result", file=stderr)
        raise SystemExit(3)
    print("work " + json.dumps(work), file=stdout)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=stderr)
    print(json.dumps(result), file=stdout)
    return result
