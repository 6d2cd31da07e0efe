"""Readings that the limits of ``cells/<workload>.json`` are set from.

    python portbench/calibrate.py --config <name> --seeds <n> [<n> ...] [--seconds <s>]

For each seed, in one process: the configuration's points are made and
built once (as its build module does), and each of its cells serves a short
window at its own load, as a run does; the sampled answers are then
held against the reference (the program's readings), and the reference
in bfloat16 answers the same queries in the program's place (the
control's readings).  One JSON line per seed and cell on standard
output.  The benchmark's own runs never run this.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import gc

    import torch

    from portbench import compare, harness, traffic

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [harness.load_cell(w["name"]) for w in bench["workloads"]
             if w["config"] == args.config]
    for seed in args.seeds:
        t = time.perf_counter()
        dep = harness.deploy(cells[0].config, seed, "cuda", cells[0].config["microbatch"])
        points = torch.from_numpy(dep.points).to("cuda")
        for cell in cells:
            tr = traffic.Traffic(cell.traffic, dep.points, seed, cell.config)
            harness.warm_up_fixed(dep.server, tr, "cuda", dep.warmup_requests)
            harness.warm_up(dep.server, tr, "cuda", dep.warmup_requests)
            res = harness.Reservoir(cell.traffic["check_sample"], seed)
            win = harness.measure(dep.server, tr, args.seconds, res, sys.stderr)
            program = compare.readings(tr.kind, points, res.items, tr.k)
            control = compare.readings(
                tr.kind, points, compare.control_answers(tr.kind, points, res.items, tr.k), tr.k)
            line = {"config": args.config, "workload": cell.workload["name"], "seed": seed,
                    "requests": len(win.latencies), "sampled": len(res.items),
                    "program": program, "control": control,
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
        del dep, points
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
