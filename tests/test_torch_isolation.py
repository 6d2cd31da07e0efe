"""The PyTorch port stands alone (``src/repro_torch/`` and ``chip_smoke.py``).

It imports neither JAX nor any module of the JAX package, its entry points
do not fall back to the CPU without being asked, and its kernel wrappers
take the plain version only for a tensor that lies on the CPU.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (
    AMBI,
    DeviceTable,
    PageStore,
    ShardedDeviceTable,
    StreamingIndex,
    bulk_load,
)
from repro_torch.core import grid_index as GI
from repro_torch.core import queries_torch as QT
from repro_torch.kernels import knn_topk, launches, ops, partition_assign, window_filter
from repro_torch.serve import DeviceQueryServer, RetrievalServer

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_files():
    # collective_ranks.py: the rank entry module that spawned test ranks
    # import; examples/torch_*.py: the example twins
    return (sorted(PORT.rglob("*.py")) + sorted((REPO / "examples").glob("torch_*.py"))
            + [REPO / "chip_smoke.py", REPO / "tests" / "collective_ranks.py"])


def test_port_files_cover_the_process_group_modules():
    """The process-group layer and every rank entry module (``run_ranks``
    spawns ranks that import them) are held to the port's import rule."""
    files = set(_port_files())
    for path in (PORT / "core" / "mesh.py", PORT / "core" / "distributed.py",
                 REPO / "chip_smoke.py", REPO / "tests" / "collective_ranks.py"):
        assert path in files and path.exists()


def test_port_files_cover_the_example_twins_and_the_lm():
    """The three example twins, the competitor loaders, the leaf metrics,
    the configs and the LM of every family are held to the port's import
    rule."""
    files = set(_port_files())
    twins = [REPO / "examples" / f"torch_{name}.py"
             for name in ("quickstart", "adaptive_workload", "knn_serving")]
    mods = [PORT / "core" / f"{name}.py" for name in ("baselines", "hilbert", "metrics")]
    mods += [PORT / "models" / f"{name}.py"
             for name in ("layers", "attention", "transformer", "model", "convert",
                          "linear_attn", "rwkv", "mamba", "moe")]
    mods += [PORT / "configs" / "base.py", PORT / "serve" / "engine.py"]
    for path in twins + mods:
        assert path in files and path.exists()


def _imported_modules(path: pathlib.Path):
    """``(module, relative)`` for every import in a file, relative imports
    resolved against the file's package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    pkg = list(path.relative_to(REPO / "src").parts[:-1]) if PORT in path.parents else []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, False
        elif isinstance(node, ast.ImportFrom) and node.level:
            base = pkg[: len(pkg) - node.level + 1] if node.level <= len(pkg) else ["<outside>"]
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod, True
        elif isinstance(node, ast.ImportFrom):
            yield node.module, False
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value, False


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    mods = list(_imported_modules(path))
    bad = [m for m, _ in mods if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"
    outside = [m for m, rel in mods if rel and not m.startswith("repro_torch")]
    assert outside == [], f"relative imports leave the package: {outside}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch, repro_torch.core.queries_torch, "
        "repro_torch.kernels.ops, repro_torch.core.datasets, "
        "repro_torch.core.grid_index, repro_torch.serve.engine, "
        "repro_torch.core.ambi, repro_torch.core.queries, "
        "repro_torch.core.distributed_torch, repro_torch.serve.resilience, "
        "repro_torch.serve.faults, repro_torch.analysis.runtime, "
        "repro_torch.core.streaming, repro_torch.serve.journal, "
        "repro_torch.serve.frontend, repro_torch.core.distributed, "
        "repro_torch.core.mesh, repro_torch.core.baselines, repro_torch.core.hilbert, "
        "repro_torch.core.metrics, repro_torch.configs, repro_torch.models, "
        "repro_torch.models.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def _index():
    rng = np.random.default_rng(0)
    pts = rng.random((1500, 2))
    return bulk_load(pts, 60, PageStore(60))


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    idx = _index()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTable.from_index(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTable.from_table(idx.table, idx.points, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        idx.table.to_device(idx.points)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueryServer.from_index(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueryServer.from_ambi(AMBI(idx.points, 60))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueryServer.from_streaming(StreamingIndex(idx.points))
    dev = idx.table.to_device(idx.points, device="cpu")
    assert dev.device.type == "cpu"
    assert QT.resolve_device("cpu") == torch.device("cpu")
    assert DeviceQueryServer.from_index(idx, device="cpu").dev.device.type == "cpu"
    srv = DeviceQueryServer.from_streaming(StreamingIndex(idx.points), device="cpu")
    assert srv.dev.device.type == "cpu"


def test_sharded_table_needs_cuda_or_cpu(monkeypatch):
    """The sharded table and a sharded server export to the card unless
    the caller passes ``device="cpu"``; on the CPU no kernel launches."""
    idx = _index()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedDeviceTable.from_index(idx, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueryServer.from_index(idx, shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueryServer.from_streaming(StreamingIndex(idx.points), shards=2)
    sdev = ShardedDeviceTable.from_index(idx, 2, device="cpu")
    assert sdev.m == 2 and all(s.device.type == "cpu" for s in sdev.shards)
    launches.reset()
    srv = DeviceQueryServer.from_index(idx, shards=2, device="cpu")
    c = np.random.default_rng(3).random((8, 2))
    srv.window(c - 0.1, c + 0.1)
    srv.knn(c, 4)
    assert srv.sdev.device.type == "cpu"
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)


def test_grid_index_and_server_need_cuda_or_cpu(monkeypatch, tmp_path):
    idx = _index()
    snap = tmp_path / "index.npz"
    idx.save(snap)
    pts = np.random.default_rng(2).random((64, 2)).astype(np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GI.build(pts, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalServer(pts, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalServer.from_snapshot(snap)
    host = idx.table.to_grid_index(idx.points)
    assert host.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host.to(None)
    assert RetrievalServer(pts, 3, device="cpu").index.device.type == "cpu"
    assert RetrievalServer.from_snapshot(snap, device="cpu").index.device.type == "cpu"


def test_collective_entry_points_need_cuda_or_cpu(monkeypatch):
    """A shard's ``GridIndex`` unpacks to the card unless the caller names
    the CPU; the host bridge to ``NodeTable`` runs on the host; a rank's
    card is named by its index, and NCCL takes only cards."""
    from repro_torch.core import distributed as D
    from repro_torch.core import mesh

    pts = np.random.default_rng(4).random((64, 2)).astype(np.float32)
    local = D.LocalShard(GI.build(pts, 3, device="cpu"), 64, 0,
                         torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1)))
    shard_out = D.stack_shards([local.arrays()])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.unpack_local_index(shard_out, 0, 3)
    assert D.unpack_local_index(shard_out, 0, 3, device="cpu").device.type == "cpu"
    (table,) = D.shard_build_tables(shard_out, 3)
    assert sorted(table.perm.tolist()) == list(range(64))
    with pytest.raises(ValueError, match="index"):
        mesh.run_ranks(D.shard_build, 1, backend="gloo", devices=["cuda"])
    with pytest.raises(ValueError, match="NCCL"):
        mesh.run_ranks(D.shard_build, 1, backend="nccl", devices=["cpu"])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_ops_raise_on_other_devices():
    i32 = torch.int32
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.box_hits_tiled(_meta(4, 2), _meta(4, 2), _meta(3, 2), _meta(3, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.leaf_mindist_tiled(_meta(3, 2), _meta(4, 2), _meta(4, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.pair_dist2(_meta(3, 2), _meta(4, 5, 2), _meta(4, dtype=i32),
                       _meta(6, dtype=i32), _meta(6, dtype=i32))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.pair_window_ids(_meta(3, 2), _meta(3, 2), _meta(4, 2), _meta(4, 2),
                            _meta(4, 5, 2), _meta(4, 5, dtype=i32),
                            _meta(4, dtype=i32), _meta(6, dtype=i32),
                            _meta(6, dtype=i32), _meta(6, dtype=i32))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.partition_assign(_meta(5, 2), _meta(2, 4, dtype=i32), _meta(2, 4), levels=2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.pairwise_dist2(_meta(3, 2), _meta(9, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.knn_topk(_meta(3, 2), _meta(9, 2), 2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.window_count_gathered(_meta(3, 2), _meta(3, 2), _meta(3, 7, 2),
                                  _meta(3, 7, dtype=i32))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.gathered_dist2(_meta(3, 2), _meta(3, 7, 2), _meta(3, 7, dtype=i32))


def test_cuda_launchers_reject_what_the_kernels_do_not_take():
    """The launchers check their arguments before anything is built or
    launched: a CPU tensor, a wrong dtype or a too-wide point raise."""
    launches.reset()
    f = torch.zeros
    with pytest.raises(ValueError, match="CUDA tensor"):
        window_filter.box_hits(f(4, 2), f(4, 2), f(3, 2), f(3, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_topk.leaf_mindist(f(3, 2), f(4, 2), f(4, 2))
    with pytest.raises(ValueError, match="1 <= d <= 64"):
        knn_topk.pair_dist2(f(3, 65), f(4, 5, 65), f(4, dtype=torch.int32),
                            f(6, dtype=torch.int32), f(6, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        window_filter.pair_window_ids(
            f(3, 2), f(3, 2), f(4, 2), f(4, 2), f(4, 5, 2),
            f(4, 5, dtype=torch.int32), f(4, dtype=torch.int32),
            f(6, dtype=torch.int32), f(6, dtype=torch.int32), f(6, dtype=torch.int32))
    i32 = torch.int32
    with pytest.raises(ValueError, match="CUDA tensor"):
        partition_assign.partition_assign(f(5, 2), f(2, 4, dtype=i32), f(2, 4), levels=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        window_filter.window_count_gathered(f(3, 2), f(3, 2), f(3, 7, 2), f(3, 7, dtype=i32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_topk.gathered_dist2(f(3, 2), f(3, 7, 2), f(3, 7, dtype=i32))
    with pytest.raises(ValueError, match="1 <= d <= 64"):
        knn_topk.pairwise_dist2(f(3, 65), f(9, 65), f(9, dtype=i32))
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)


def test_cpu_path_launches_no_kernel():
    idx = _index()
    dev = DeviceTable.from_index(idx, device="cpu", compressed=True)
    launches.reset()
    c = np.random.default_rng(1).random((8, 2))
    QT.window_query_batch_torch(dev, c - 0.1, c + 0.1)
    QT.knn_query_batch_torch(dev, c, 4)
    srv = RetrievalServer(idx.points, 4, adaptive=True, device="cpu")
    srv.knn(c, 4)
    srv.knn_kernel(c, 4)
    GI.window_count(srv.index, c - 0.1, c + 0.1)
    adaptive = DeviceQueryServer.from_ambi(AMBI(idx.points, 4), device="cpu")
    adaptive.window(c - 0.1, c + 0.1)
    adaptive.knn(c, 4)
    assert adaptive.stats.hot_queries > 0
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)


def test_recover_forwards_the_device(monkeypatch, tmp_path):
    """``recover`` boots the recovered server where the caller asks, and
    on the card by default (raising without one)."""
    idx = _index()
    live = DeviceQueryServer.from_streaming(
        StreamingIndex(idx.points), journal_path=tmp_path / "j",
        snapshot_path=tmp_path / "s.npz", device="cpu")
    live.insert(idx.points[:5])
    rec = DeviceQueryServer.recover(tmp_path / "s.npz", tmp_path / "j", device="cpu")
    assert rec.dev.device.type == "cpu" and rec.stats.replayed_records == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceQueryServer.recover(tmp_path / "s.npz", tmp_path / "j")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card here: the script exits non-zero and prints no result, in the
    repo and in a directory that holds nothing else of it."""
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    run = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
