"""Generate the §Dry-run and §Roofline tables from
``experiments/dryrun_torch/*.json`` (the port of the JAX package's
``launch/report.py``), with the port's ``roofline`` (H100 constants).

  PYTHONPATH=src python -m repro_torch.launch.report > experiments/roofline_torch.md
"""
from __future__ import annotations

import json
import math
import pathlib

from .. import roofline
from ..configs.base import SHAPES, get_config

DRYRUN = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def load_cells(directory=None) -> list[dict]:
    d = pathlib.Path(directory) if directory is not None else DRYRUN
    return [json.loads(f.read_text()) for f in sorted(d.glob("*.json"))]


def roofline_row(rec: dict) -> dict:
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    chips = math.prod(int(n) for n in rec["mesh"].split("x"))
    n_micro = rec.get("n_micro", 1)
    ana = roofline.analytic_flops(cfg, shape, n_micro)
    flops = ana["total_flops"]
    if "probe" in rec:
        # per-block traced numbers, extrapolated to full depth
        ext = roofline.probe_extrapolate(rec["probe"], cfg.n_blocks)
        hbm = ext["bytes_accessed"] * chips  # probes report per-device
        probe_flops = ext["flops"] * chips
    else:
        hbm = rec["cost_analysis_raw"]["bytes_accessed"] * chips
        probe_flops = rec["cost_analysis_raw"]["flops"] * chips
    if hbm <= 0:
        hbm = roofline.analytic_hbm_bytes(cfg, shape, n_micro)
    coll = rec["collectives"]["total_bytes"]
    terms = roofline.roofline_terms(flops, hbm, coll, chips)
    model_flops = ana["model_flops_6nd"]
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "kind": rec["kind"],
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "dominant": terms["dominant"].replace("_s", ""),
        "roofline_fraction": terms["roofline_fraction"],
        "flops_analytic": flops,
        "flops_probe": probe_flops,
        "model_flops_6nd": model_flops,
        "useful_ratio": model_flops / flops if flops else 0.0,
        "hbm_bytes": hbm,
        "coll_bytes": coll,
        "temp_gib_dev": rec["memory"]["temp_bytes_per_device"] / 2**30,
        "args_gib_dev": rec["memory"]["argument_bytes_per_device"] / 2**30,
    }


def main(directory=None):
    cells = load_cells(directory)
    by_cell: dict = {}
    for r in cells:
        by_cell.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    meshes = sorted({r["mesh"] for r in cells}, key=lambda m: (m.count("x"), m))
    print("## Dry run (per device, traced under FakeTensorMode; "
          f"each cell: {' / '.join(meshes)})\n")
    print("| arch | shape | depth | args GiB | temp GiB | TFLOP | coll GiB | trace s |")
    print("|---|---|---|---|---|---|---|---|")

    def col(recs, fn):
        return " / ".join(fn(recs[m]) if m in recs else "-" for m in meshes)

    def gib(section, key):
        return lambda r: f"{r[section][key] / 2**30:.2f}"

    for (arch, shape), recs in sorted(by_cell.items()):
        fields = [" / ".join(sorted({r.get("depth", "full") for r in recs.values()})),
                  col(recs, gib("memory", "argument_bytes_per_device")),
                  col(recs, gib("memory", "temp_bytes_per_device")),
                  col(recs, lambda r: f"{r['cost_analysis_raw']['flops'] / 1e12:.4g}"),
                  col(recs, gib("collectives", "total_bytes")),
                  col(recs, lambda r: str(r["trace_s"]))]
        print(f"| {arch} | {shape} | " + " | ".join(fields) + " |")
    print()
    rows = [roofline_row(r) for r in cells if r["mesh"] == "16x16"]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    print("## Roofline (16x16, H100 constants)\n")
    print("| arch | shape | compute_s | memory_s | collective_s | dominant "
          "| roofline_frac | 6ND/HLO | temp GiB/dev |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.2e} "
            f"| {r['memory_s']:.2e} | {r['collective_s']:.2e} "
            f"| {r['dominant']} | {r['roofline_fraction']:.2f} "
            f"| {r['useful_ratio']:.2f} | {r['temp_gib_dev']:.1f} |"
        )
    print()
    mp = [r for r in cells if r["mesh"] == "2x16x16"]
    print(f"multi-pod (2x16x16) cells traced: {len(mp)}")


if __name__ == "__main__":
    main()
