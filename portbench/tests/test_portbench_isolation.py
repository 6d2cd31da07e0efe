"""Nothing the benchmark runs may load JAX or the JAX package, compared
by whole top-level module names."""
import json
import os
import pathlib
import subprocess
import sys

from portbench import isolation

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_top_level_names_compare_whole():
    assert isolation.forbidden_loaded(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert isolation.forbidden_loaded(["repro.core.fmbi", "numpy"]) == ["repro"]
    assert isolation.forbidden_loaded(["jax._src", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_a_cpu_run_loads_neither_jax_nor_repro():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import io, json\n"
        "from portbench import harness, isolation\n"
        "harness.run_cell('nycyt5d.knn', 7, 0.2, True, device='cpu', "
        "sizes={'n_points': 5000, 'queries_per_request': 32}, sample=16, "
        "stdout=io.StringIO(), stderr=io.StringIO())\n"
        "print(json.dumps(isolation.forbidden_loaded()))\n"
    ) % (str(ROOT), str(ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_without_the_program_there_is_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: no result line."""
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    os.symlink(ROOT / "portbench", tmp_path / "portbench")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nycyt5d.knn",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")
