"""The port's example twins (``examples/torch_*.py``) run end to end at a
small size on the CPU (``--device cpu``: the device engine's plain
versions), and every parity they print holds."""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "torch_quickstart.py": (30_000, ["the 32 windows answer identically: True",
                                     "reloaded index answers identically: True",
                                     "fully refined: True"]),
    "torch_adaptive_workload.py": (40_000, ["fully refined = True",
                                            "64 windows answer as the host AMBI does: True"]),
    "torch_knn_serving.py": (20_000, ["tree-pruned vs kernel distances agree: True",
                                      "id-parity vs NumPy engine: windows True, knn True",
                                      "id-parity vs single-table engine: windows True, knn True",
                                      "64/64 complete again",
                                      "bit-identical table: True",
                                      "identical to the never-killed twin: True",
                                      "carries a completeness certificate: True",
                                      "id-identical to the offline engine: True"]),
}


def run_example(name, n, device):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, str(REPO / "examples" / name), "--n", str(n),
                           "--device", device],
                          cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_twin_runs_on_the_cpu(name):
    n, lines = CASES[name]
    run = run_example(name, n, "cpu")
    assert run.returncode == 0, run.stdout + run.stderr
    for line in lines:
        assert line in run.stdout, (line, run.stdout)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_twin_imports_only_the_port(name):
    """Run with the JAX package made unimportable: the twin needs neither."""
    n, _ = CASES[name]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['{name}', '--n', '{n}', '--device', 'cpu']\n"
            f"runpy.run_path('{REPO / 'examples' / name}', run_name='__main__')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr


def test_example_twin_needs_a_card_by_default():
    """Without ``--device`` a twin exports to ``cuda`` and raises here."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(REPO / "examples" / "torch_knn_serving.py"),
                          "--n", "2000"], cwd=str(REPO), env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode != 0 and "no CUDA device" in run.stderr


def test_train_lm_twin_runs_on_the_cpu(tmp_path):
    """``examples/torch_train_lm.py --tiny`` trains the reduced qwen3 for 4
    steps on the CPU with the JAX package made unimportable, its
    checkpoints under ``TMPDIR``."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), TMPDIR=str(tmp_path))
    name = "torch_train_lm.py"
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['{name}', '--tiny', '--device', 'cpu', '--steps', '4']\n"
            f"runpy.run_path('{REPO / 'examples' / name}', run_name='__main__')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    steps = [line for line in run.stdout.splitlines() if line.startswith("step ")]
    assert len(steps) == 4 and "loss: first" in run.stdout, run.stdout
    assert (tmp_path / "repro_torch_train_lm_tiny").is_dir()
