"""The port's dry run (``repro_torch.launch.dryrun``) and its report
(``launch.report``) on the CPU.

  * ``run_cell`` on a reduced config at a fake ``(2, 2)`` mesh writes the
    reference's keys for a train, a prefill and a decode cell (``trace_s``
    in the place of ``compile_s``), and ``report.main`` renders them.
  * A model deeper than ``MAX_TRACED_BLOCKS`` superblocks is traced at 1
    and 2 and extrapolated: every number equals the full-depth trace's.
  * Argument bytes, exactly: a reduced dense config's train step on a
    ``(2, 2)`` mesh holds as many bytes of arguments per device as XLA's
    ``memory_analysis().argument_size_in_bytes`` for the reference's step
    (a subprocess with 4 host devices).
  * ``main`` exits 1 and names every failed cell; ``launch.dryrun`` and
    ``launch.report`` import no JAX.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.train import reduced_config

REPO = pathlib.Path(__file__).resolve().parents[1]
REFERENCE_KEYS = {"arch", "shape", "mesh", "kind", "memory", "cost_analysis_raw",
                  "collectives", "hlo_ops"}
MEMORY_KEYS = {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "alias_bytes_per_device"}


@pytest.fixture(scope="module")
def mesh22():
    fake_world(4)
    yield make_mesh((2, 2), ("data", "model"))
    dist.destroy_process_group()


def _shape(name, seq=64, batch=4):
    return dataclasses.replace(SHAPES[name], seq_len=seq, global_batch=batch)


@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "train_4k"),
                                        ("qwen3-moe-235b-a22b", "prefill_32k"),
                                        ("rwkv6-3b", "decode_32k")])
def test_run_cell_writes_the_reference_keys(mesh22, tmp_path, monkeypatch, arch, shape):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    cfg = reduced_config(get_config(arch))
    rec = dryrun.run_cell(cfg, _shape(shape), mesh22, probes=True)
    assert REFERENCE_KEYS | {"trace_s", "probe", "depth"} == set(rec) - {
        "optimizer", "n_micro", "accum_dtype"}
    if rec["kind"] == "train":
        assert rec["optimizer"] == "adamw" and rec["n_micro"] == 1
        assert rec["accum_dtype"] == "float32"
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["memory"]["argument_bytes_per_device"] > 0
    assert rec["memory"]["temp_bytes_per_device"] > 0
    assert rec["cost_analysis_raw"]["flops"] > 0
    assert set(rec["collectives"]) == {"by_kind", "counts", "total_bytes"}
    assert rec["collectives"]["total_bytes"] > 0
    assert set(rec["probe"]) == {"blocks1", "blocks2"}
    assert rec["mesh"] == "2x2"
    saved = json.loads((tmp_path / f"{cfg.name}_{shape}_2x2.json").read_text())
    assert saved == json.loads(json.dumps(rec))
    report.main(directory=tmp_path)          # renders


def test_extrapolated_cell_equals_the_full_trace(mesh22):
    cfg = reduced_config(get_config("qwen3-0.6b"), layers=4)
    assert cfg.n_blocks > dryrun.MAX_TRACED_BLOCKS
    shape = _shape("train_4k", batch=8)
    ext = dryrun.run_cell(cfg, shape, mesh22, save=False, force_micro=2)
    full = dryrun.run_cell(cfg, shape, mesh22, save=False, force_micro=2, full_depth=True)
    assert ext["depth"] == "extrapolated" and full["depth"] == "full"
    for key in ("memory", "cost_analysis_raw", "collectives", "hlo_ops"):
        assert ext[key] == full[key], key


ARGS_SCRIPT = r"""
import os, sys
sys.path.insert(0, "src")
from repro.launch import dryrun              # sets 512 forced host devices
import numpy as np, jax, dataclasses
from repro.configs.base import SHAPES, get_config
from repro.launch.train import reduced_config
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cfg = reduced_config(get_config("qwen3-0.6b"))
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
_, compiled, meta = dryrun.lower_cell(cfg, shape, mesh)
print("ARGS", compiled.memory_analysis().argument_size_in_bytes, meta["n_micro"])
"""


def test_argument_bytes_equal_xla(mesh22):
    res = subprocess.run([sys.executable, "-c", ARGS_SCRIPT], cwd=str(REPO),
                         capture_output=True, text=True, timeout=600)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("ARGS")]
    assert line, res.stdout + res.stderr
    xla_args, xla_micro = (int(v) for v in line[0].split()[1:])
    cfg = reduced_config(get_config("qwen3-0.6b"))
    _, memory, meta = dryrun.lower_cell(cfg, _shape("train_4k", batch=8), mesh22, trace=False)
    assert meta["n_micro"] == xla_micro
    assert memory["argument_bytes_per_device"] == xla_args


def test_main_exits_one_and_names_failed_cells(mesh22, monkeypatch, capsys):
    def fail(cfg, shape, mesh, **kw):
        raise RuntimeError(f"no sharding rule for {cfg.name}")

    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod: mesh22)
    monkeypatch.setattr(dryrun, "run_cell", fail)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--single-pod-only"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "1 FAILURES" in out and "qwen3-0.6b x decode_32k @ 2x2" in out


def test_dryrun_and_report_import_no_jax():
    code = ("import sys; import repro_torch.launch.dryrun, repro_torch.launch.report, "
            "repro_torch.roofline; bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'repro.'))]; print('BAD', bad)")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                         text=True, timeout=120, env={**__import__("os").environ,
                                                      "PYTHONPATH": str(REPO / "src")})
    assert "BAD []" in res.stdout, res.stdout + res.stderr


def test_adafactor_state_of_one_block_c12(mesh22):
    """ROADMAP C.12: at one superblock a stacked norm scale is ``(1, D)``;
    the reference's Adafactor gives it ``v`` state and row/column specs
    (its dry run's tree map then raises), the port places that ``v`` like
    its leaf."""
    import jax
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs.base import get_config as jget_config
    from repro.launch.train import reduced_config as jreduced
    from repro.models import model as JM
    from repro.models.layers import shape_tree
    from repro.models.sharding import MeshAxes
    from repro.train import optimizer as jopt
    from repro_torch.models import model as M
    from repro_torch.models.convert import reference_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import init_state

    jcfg = dataclasses.replace(jreduced(jget_config("qwen3-moe-235b-a22b")), n_layers=1)
    shapes = shape_tree(JM.model_defs(jcfg), jax.numpy.float32)
    opt = jopt.get_optimizer("adafactor")
    state = jax.eval_shape(opt.init, shapes)
    specs = opt.state_specs(JM.param_pspecs(jcfg, MeshAxes()))
    mismatched = [i for i, (st, sp) in enumerate(zip(state, specs)) if set(st) != set(sp)]
    assert mismatched

    cfg = dataclasses.replace(reduced_config(get_config("qwen3-moe-235b-a22b")), n_layers=1)
    with FakeTensorMode(allow_non_fake_inputs=True):
        lm = M.abstract_params(cfg, mesh22)
        got = init_state(opt_mod.get_optimizer("adafactor"), lm)
        leaves = reference_leaves(cfg, [n for n, _ in lm.named_parameters()])
        for i in mismatched:
            assert set(got[i]) == {"v"}
            assert got[i]["v"].shape == (1,) + tuple(dict(lm.named_parameters())[
                leaves[i][1][0]].shape)
