"""Run one cell of ``BENCHMARK.json`` once on the card.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the run's work summary, then one JSON result line last on
standard output, and each compared number beside its limit last on
standard error.  Exits non-zero, with no result, without enough CUDA
devices or where JAX or the JAX package was loaded.

The port builds its CUDA kernels with nvcc into ``build/repro_torch/``
inside the checkout (``repro_torch/kernels/build.py``), a fixed path, so
only a checkout's first run compiles.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# a fixed, small host thread count: one client, and runs that repeat
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness

    chips = harness.load_cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                     t_start=T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
