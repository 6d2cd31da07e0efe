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

from repro_torch.core import AMBI, DeviceTable, PageStore, bulk_load
from repro_torch.core import grid_index as GI
from repro_torch.core import queries_torch as QT
from repro_torch.kernels import knn_topk, launches, ops, partition_assign, window_filter
from repro_torch.serve import DeviceQueryServer, RetrievalServer

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


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
        "repro_torch.serve.faults, repro_torch.analysis.runtime\n"
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
    dev = idx.table.to_device(idx.points, device="cpu")
    assert dev.device.type == "cpu"
    assert QT.resolve_device("cpu") == torch.device("cpu")
    assert DeviceQueryServer.from_index(idx, device="cpu").dev.device.type == "cpu"


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
