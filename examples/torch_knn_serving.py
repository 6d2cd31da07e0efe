"""Serve batched k-NN queries from an FMBI index on the PyTorch port: exact
tree-pruned search on the balanced grid index, the brute-force CUDA
distance-kernel path, AMBI-style adaptive residency for a focused query
stream, booting a server from a bulk-loaded NodeTable snapshot without
rebuilding, the device query engine (bulk load on the host, serve windows
and k-NN from the card with id-identical results), and sharded serving
(paper Section 5): the table partitions into m DeviceTables behind a
subspace-MBB router, windows fan out only to qualified shards, and k-NN
runs the certified two-round protocol.  The last sections exercise the
fault-tolerance layer (a seeded fault kills a shard: certified partial
answers, then repair), graft-journal crash recovery and the async
frontend.

    PYTHONPATH=src python examples/torch_knn_serving.py [--n 200000] [--device cuda]
"""
import argparse
import pathlib
import tempfile
import time

import numpy as np

from repro_torch.core import AMBI, PageStore, bulk_load, knn_query_batch, window_query_batch
from repro_torch.core.datasets import nycyt_like
from repro_torch.serve import (
    DeviceQueryServer,
    FaultPlan,
    FaultRule,
    Frontend,
    RetrievalServer,
    RetryPolicy,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000, help="number of trip records")
    ap.add_argument("--device", default="cuda", help="where every server lives")
    args = ap.parse_args(argv)
    device = args.device

    print(f"indexing {args.n} 5-D trip records (NYCYT-like) on {device}...")
    # float32-representable coordinates: the device engine's exact-parity
    # contract (see core/queries_torch.py) holds bit for bit
    points = nycyt_like(args.n, d=5, seed=0).astype(np.float32).astype(np.float64)
    server = RetrievalServer(points, levels=8, device=device)

    rng = np.random.default_rng(1)
    queries = rng.random((64, 5)).astype(np.float32)

    server.knn(queries, k=16, n_candidate_leaves=16)   # first call: kernels load
    t0 = time.time()
    rows, d2, exact = server.knn(queries, k=16, n_candidate_leaves=16)
    print(f"batch of 64 16-NN queries: {time.time()-t0:.3f}s "
          f"(exact certificates: {np.mean(exact):.0%})")

    t0 = time.time()
    _, d2k = server.knn_kernel(queries, k=16)
    print(f"brute-force kernel path: {time.time()-t0:.3f}s")
    agree = np.array_equal(d2[exact], d2k[exact])
    print(f"tree-pruned vs kernel distances agree: {agree}")

    # ---- snapshot boot: host bulk load -> .npz -> device serving ----------
    print("\nboot from a NodeTable snapshot (no rebuild):")
    idx = bulk_load(points, 400, PageStore(400))
    with tempfile.TemporaryDirectory() as tmp:
        snap = pathlib.Path(tmp) / "index.npz"
        idx.save(snap)
        t0 = time.time()
        snap_server = RetrievalServer.from_snapshot(snap, device=device)
        boot = time.time() - t0
        _, _, exact_s = snap_server.knn(queries, k=16, n_candidate_leaves=16)
        print(f"  bridged {idx.table.n_nodes}-row table in {boot:.3f}s; "
              f"exact certificates: {np.mean(exact_s):.0%}")

    # ---- device engine: NodeTable -> DeviceTable ---------------------------
    print("\ndevice query engine (microbatched, id-identical):")
    dev_srv = DeviceQueryServer.from_index(idx, microbatch=64, device=device)
    los = queries - np.float32(0.03)
    his = queries + np.float32(0.03)
    dev_srv.window(los, his)          # warm-up
    dev_srv.knn(queries, 16)
    t0 = time.time()
    dev_windows = dev_srv.window(los, his)
    t_w = time.time() - t0
    t0 = time.time()
    dev_knn = dev_srv.knn(queries, 16)
    t_k = time.time() - t0
    cpu_windows, _ = window_query_batch(idx, los.astype(np.float64), his.astype(np.float64))
    cpu_knn, _ = knn_query_batch(idx, queries.astype(np.float64), 16)
    w_ok = all(np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(dev_windows, cpu_windows))
    k_ok = all(np.array_equal(a, b) for a, b in zip(dev_knn, cpu_knn))
    print(f"  64 windows {t_w*1e3:.1f} ms, 64 16-NN {t_k*1e3:.1f} ms "
          f"({dev_srv.stats.microbatches} microbatches)")
    print(f"  id-parity vs NumPy engine: windows {w_ok}, knn {k_ok}")

    # ---- sharded serving: m DeviceTables behind the subspace router -------
    print("\nsharded serving (4 shards, two-round certified k-NN):")
    shard_srv = DeviceQueryServer.from_index(idx, microbatch=64, shards=4, device=device)
    shard_srv.window(los, his)        # warm-up
    shard_srv.knn(queries, 16)
    t0 = time.time()
    sh_windows = shard_srv.window(los, his)
    t_w = time.time() - t0
    t0 = time.time()
    sh_knn = shard_srv.knn(queries, 16)
    t_k = time.time() - t0
    w_ok = all(np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(sh_windows, dev_windows))
    k_ok = all(np.array_equal(a, b) for a, b in zip(sh_knn, dev_knn))
    print(f"  {shard_srv.stats.shards} shards: 64 windows {t_w*1e3:.1f} ms, "
          f"64 16-NN {t_k*1e3:.1f} ms")
    print(f"  id-parity vs single-table engine: windows {w_ok}, knn {k_ok}")

    # ---- adaptive serving: AMBI residency policy --------------------------
    print("\nadaptive residency (focused stream over one city):")
    adaptive = RetrievalServer(points, levels=8, adaptive=True, hot_capacity=32,
                               device=device)
    for step in range(20):
        qs = (rng.random((32, 5)) * 0.1 + 0.45).astype(np.float32)
        adaptive.knn(qs, k=8)
        if step in (0, 4, 19):
            print(f"  after {adaptive.stats.queries:4d} queries: "
                  f"hot-leaf hit rate {adaptive.stats.hit_rate:.0%}")

    # ---- adaptive device serving: AMBI behind the device engine -----------
    # boot from the single-unrefined-root state: nothing is indexed yet.
    # Cold queries are answered by the host AMBI engine (charging the
    # paper's I/O and grafting the touched subspaces); each graft reaches
    # the card as an incremental delta, and the pinned hotspot becomes
    # fully device-resident: no host I/O at steady state.
    print("\nadaptive device serving (partial index, incremental refresh):")
    ambi = AMBI(points, 400)
    adaptive_dev = DeviceQueryServer.from_ambi(ambi, microbatch=64, device=device)
    hot_c = (rng.random((64, 5)) * 0.08 + 0.45).astype(np.float32)
    hot_lo, hot_hi = hot_c - np.float32(0.02), hot_c + np.float32(0.02)
    t0 = time.time()
    adaptive_dev.window(hot_lo, hot_hi)
    print(f"  first hotspot batch (host refine + delta upload): "
          f"{time.time()-t0:.3f}s, grafts={adaptive_dev.stats.grafts}")
    t0 = time.time()
    adaptive_dev.window(hot_lo, hot_hi)
    s = adaptive_dev.stats
    print(f"  steady-state batch (device only): {time.time()-t0:.3f}s; "
          f"hot {s.hot_queries}, cold {s.cold_queries}, "
          f"delta refreshes {s.delta_refreshes}, "
          f"partial: {not ambi.is_fully_refined()}")
    u = adaptive_dev.upload_stats
    print(f"  uploads: {u['full_exports']} full export (the boot), "
          f"{u['delta_refreshes']} deltas, {u['uploaded_leaf_blocks']} leaf blocks "
          f"total (= {adaptive_dev.dev.n_leaves} resident leaves)")

    # ---- degraded serving: a dead shard with completeness certificates ----
    # an unbounded fault kills shard 2; retries exhaust, its breaker opens,
    # and queries opting into `return_certs` get partial answers whose
    # certificate names the unanswered subspace
    print("\ndegraded serving (seeded fault kills shard 2):")
    plan = FaultPlan([FaultRule("shard_dispatch", rate=1.0, match={"shard": 2})], seed=0)
    deg_srv = DeviceQueryServer.from_index(
        idx, microbatch=64, shards=4, fault_plan=plan,
        retry=RetryPolicy(max_attempts=2, sleep=lambda s: None),
        breaker_threshold=1, device=device,
    )
    res, certs = deg_srv.window(los, his, return_certs=True)
    down = [c for c in certs if not c.complete]
    print(f"  {len(res) - len(down)}/{len(res)} windows complete; {len(down)} partial"
          + (f", each certifying shard {down[0].missing_shards} unanswered" if down else ""))
    _, kcerts = deg_srv.knn(queries, 16, return_certs=True)
    n_exact = sum(c.certified_exact for c in kcerts)
    print(f"  k-NN: {n_exact}/{len(kcerts)} certified exact, "
          f"{sum(not c.complete for c in kcerts)} honestly partial "
          f"(exact over the 3 alive shards)")
    plan.disarm()                   # the operator fixed the fault...
    repaired = deg_srv.repair()     # ...and rebuilt the shard from the host
    _, certs2 = deg_srv.window(los, his, return_certs=True)
    print(f"  repaired shards {repaired}: "
          f"{sum(c.complete for c in certs2)}/{len(certs2)} complete again")

    # ---- crash recovery: graft journal + snapshot barrier -----------------
    print("\ncrash recovery (journaled adaptive serving):")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        durable = DeviceQueryServer.from_ambi(
            AMBI(points, 400), microbatch=64,
            journal_path=tmp / "grafts.journal", snapshot_path=tmp / "snapshot.npz",
            compact_slack=5.0,  # keep the ops in the journal for the demo
            device=device,
        )
        durable.window(hot_lo, hot_hi)
        print(f"  served 1 hotspot batch: {durable.stats.journal_records} "
              f"journaled cold ops after {durable.stats.checkpoints} "
              f"snapshot barrier (boot)")
        t0 = time.time()  # kill -9 here; the reboot path is:
        recovered = DeviceQueryServer.recover(
            tmp / "snapshot.npz", tmp / "grafts.journal", microbatch=64, device=device)
        boot = time.time() - t0
        identical = recovered.ambi.table.equals(durable.ambi.table)
        print(f"  recovered in {boot:.3f}s: replayed "
              f"{recovered.stats.replayed_records} records -> "
              f"bit-identical table: {identical}")
        a = recovered.window(hot_lo, hot_hi)
        b = durable.window(hot_lo, hot_hi)
        same = all(np.array_equal(x, y) for x, y in zip(a, b))
        print(f"  post-recovery serving identical to the never-killed twin: {same}")

    # ---- async frontend: a burst against the bounded admission queue ------
    print("\nasync frontend (burst at a queue bound of 96):")
    fe = Frontend(
        dev_srv, queue_bound=96, batch_max=64, batch_window_s=0.002,
        default_deadline_s=5.0, brownout_high=64, brownout_low=16,
        brownout_knn_rounds=1,
    ).start()
    burst = []
    for i in range(256):  # ~2.7x the queue bound, submitted full throttle
        if i % 4 == 3:
            burst.append(fe.submit_knn(rng.random(5), 16))
        else:
            c = rng.random(5) * 0.9
            burst.append(fe.submit_window(c - 0.03, c + 0.03))
    for r in burst:
        r.wait(30.0)
    fe.stop()
    st = fe.stats
    ok = [r for r in burst if r.status == "ok"]
    lat = np.array([r.latency for r in ok])
    print(f"  served {st.completed}/{st.submitted} "
          f"(rejected {st.rejected}, timed out {st.timed_out}, "
          f"shed {st.shed}); peak queue depth {st.depth_peak} <= 96")
    print(f"  p50 {np.percentile(lat, 50)*1e3:.1f} ms, "
          f"p99 {np.percentile(lat, 99)*1e3:.1f} ms over "
          f"{st.batches} microbatches ({st.brownout_batches} brownout)")
    dropped = [r for r in burst if r.status != "ok"]
    certified = all(r.cert is not None and not r.cert.complete for r in dropped)
    print(f"  every dropped request carries a completeness certificate: {certified}")
    sample = [r for r in ok if r.kind == "window"][:8]
    ref = dev_srv.window(np.stack([r.payload[0] for r in sample]),
                         np.stack([r.payload[1] for r in sample]))
    exact = all(np.array_equal(np.sort(r.ids), np.sort(e)) for r, e in zip(sample, ref))
    print(f"  admitted answers id-identical to the offline engine: {exact}")


if __name__ == "__main__":
    main()
