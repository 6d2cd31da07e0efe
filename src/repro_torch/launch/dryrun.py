"""Multi-pod dry run: trace every (architecture x shape x mesh) without
hardware (the port of the JAX package's ``launch/dryrun.py``).

For each cell the step (train / prefill / decode by the shape's kind) runs
once under ``FakeTensorMode`` on the production mesh of a fake process
group (``launch/mesh.make_production_mesh``): the LM's parameters,
optimizer state and inputs are fake DTensors at the cell's shapes
(``models/model.abstract_params``, ``input_specs``), nothing is
allocated, and :class:`roofline.StepTrace` counts rank 0's local work.
Where the reference compiles with XLA and reads ``memory_analysis``,
``cost_analysis`` and the HLO text, the record holds, per device:

  memory.argument_bytes_per_device   the local shards of parameters,
                                     optimizer state and inputs (and the
                                     int32 step of a train cell)
  memory.temp_bytes_per_device       the traced peak of live local
                                     storages, less the arguments
  memory.output_bytes_per_device     the local outputs (logits, a cache)
  memory.alias_bytes_per_device      what the train step updates in place
                                     (parameters and optimizer state)
  cost_analysis_raw                  FLOPs (local tensors) and unfused
                                     bytes accessed
  collectives                        DTensor's collectives by kind
  hlo_ops                            the op census (the reference's
                                     categories over ATen ops)
  trace_s                            seconds to trace (``compile_s``'s place)

and, with ``--probes``, the 1- and 2-superblock variants (``probe``).
Records go to ``experiments/dryrun_torch/`` (git-ignored).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-20b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --probes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch

from ..configs.base import SHAPES, cells, get_config
from ..models import model as M
from ..roofline import StepTrace
from ..train import optimizer as opt_mod
from ..train.trainer import data_ways, init_state, make_train_step, pick_microbatches
from .mesh import make_production_mesh, mesh_tag, use_mesh

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments"
OUT_DIR = RESULTS_DIR / "dryrun_torch"
# deeper models are traced at 1 and 2 superblocks and extrapolated
MAX_TRACED_BLOCKS = 2


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local_bytes(tree) -> int:
    return sum(t.to_local().nbytes if isinstance(t, M.DTensor) else t.nbytes
               for t in _tensors(tree))


def _probe_cfg(cfg, blocks: int, *, remainder: bool):
    """``cfg`` at ``blocks`` superblocks (the encoder cut to at most as many
    layers), its remainder layers kept when ``remainder``."""
    rem = cfg.remainder_layers if remainder else 0
    return dataclasses.replace(
        cfg, n_layers=blocks * cfg.superblock + rem,
        encoder_layers=min(cfg.encoder_layers, blocks) if cfg.encoder_layers else 0)


def lower_cell(cfg, shape, mesh, *, probe_blocks: int | None = None,
               extra_cfg: dict | None = None, force_micro: int | None = None,
               remainder: bool = False, trace: bool = True):
    """Trace one cell.  Returns ``(trace, memory, meta)``: the
    :class:`StepTrace` (None when ``trace`` is off: only the arguments
    are built), the memory record and the cell's meta (kind, optimizer,
    microbatches).

    probe_blocks: if set, traces a depth-reduced variant (the roofline
    probe) with that many superblocks, and the remainder layers only when
    ``remainder``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    if probe_blocks is not None:
        cfg = _probe_cfg(cfg, probe_blocks, remainder=remainder)
    st = StepTrace()
    with FakeTensorMode(allow_non_fake_inputs=True):
        lm = M.abstract_params(cfg, mesh)
        inputs = M.input_specs(cfg, shape, mesh)
        params = list(lm.parameters())
        out, alias = None, 0
        if shape.kind == "train":
            opt_name = opt_mod.pick_for(cfg)
            optimizer = opt_mod.get_optimizer(opt_name)
            opt_state = init_state(optimizer, lm)
            n_micro = force_micro or pick_microbatches(cfg, shape, data_ways(mesh))
            accum = torch.bfloat16 if opt_name == "adafactor" else torch.float32
            step = torch.zeros((), dtype=torch.int32)
            st.add_arguments([*params, *_tensors(opt_state), *_tensors(inputs), step])
            if trace:
                step_fn = make_train_step(lm, optimizer, n_micro, accum_dtype=accum)
                with st, use_mesh(mesh):
                    opt_state, out = step_fn(opt_state, inputs, step)
            alias = _local_bytes(params) + _local_bytes(opt_state)
            meta = {"kind": "train", "optimizer": opt_name, "n_micro": n_micro,
                    "accum_dtype": str(accum).removeprefix("torch.")}
        elif shape.kind == "prefill":
            st.add_arguments([*params, *_tensors(inputs)])
            if trace:
                with st, use_mesh(mesh):
                    out = lm.prefill(inputs["tokens"], frames=inputs.get("frames"),
                                     patch_embeds=inputs.get("patch_embeds"))
            meta = {"kind": "prefill"}
        else:
            st.add_arguments([*params, *_tensors(inputs)])
            if trace:
                with st, use_mesh(mesh):
                    out = lm.decode_step(inputs["token"], inputs["cache"], inputs["pos"])
            alias = _local_bytes(inputs["cache"])     # the cache is updated in place
            meta = {"kind": "decode"}
        memory = {
            "argument_bytes_per_device": st.arg_bytes,
            "output_bytes_per_device": _local_bytes(out),
            "temp_bytes_per_device": st.peak_bytes - st.arg_bytes,
            "alias_bytes_per_device": alias,
        }
    return (st if trace else None), memory, meta


def _counts(trace, memory) -> dict:
    """A trace's numbers, flat: ``(section, key) -> value``."""
    flat = {("cost_analysis_raw", "flops"): float(trace.flops),
            ("cost_analysis_raw", "bytes_accessed"): float(trace.bytes_accessed),
            ("collectives", "total_bytes"): trace.collectives()["total_bytes"]}
    for kind, v in trace.collectives()["by_kind"].items():
        flat[("by_kind", kind)] = v
    for kind, v in trace.collectives()["counts"].items():
        flat[("counts", kind)] = v
    for k, v in trace.op_census().items():
        flat[("hlo_ops", k)] = v
    for k in ("temp_bytes_per_device", "output_bytes_per_device"):
        flat[("memory", k)] = memory[k]
    return flat


def _extrapolate(one: dict, two: dict, n_blocks: int) -> dict:
    """``total(n) = base + per_block * n`` from the 1- and 2-superblock
    traces (``probe_extrapolate``'s rule), per number."""
    out = {}
    for key in set(one) | set(two):
        a, b = one.get(key, 0), two.get(key, 0)
        v = a + (b - a) * (n_blocks - 1)
        out[key] = int(round(v)) if isinstance(a, int) and isinstance(b, int) else float(v)
    return out


def run_cell(cfg, shape, mesh, *, probes: bool = False, save: bool = True,
             extra_cfg: dict | None = None, tag: str = "",
             force_micro: int | None = None, full_depth: bool = False) -> dict:
    """Trace a cell and record it (and save it under ``OUT_DIR``).

    A model of more than ``MAX_TRACED_BLOCKS`` superblocks is traced at 1
    and 2 superblocks (with its remainder layers) and every count and the
    temporary and output bytes are extrapolated linearly to its depth
    (``"depth": "extrapolated"``): each superblock adds the same ops, and
    tracing runs every op in Python.  Its argument and alias bytes are
    those of the full model, built but not run.  ``full_depth`` traces the
    whole model whatever its depth."""
    t0 = time.time()
    cfg_x = dataclasses.replace(cfg, **extra_cfg) if extra_cfg else cfg
    kw = dict(extra_cfg=extra_cfg, force_micro=force_micro)
    traced = {}
    if full_depth or cfg_x.n_blocks <= MAX_TRACED_BLOCKS:
        trace, memory, meta = lower_cell(cfg, shape, mesh, **kw)
        flat = _counts(trace, memory)
        depth = "full"
    else:
        for nb in (1, 2):
            t, m, _ = lower_cell(cfg, shape, mesh, probe_blocks=nb, remainder=True, **kw)
            traced[nb] = (t, m)
        flat = _extrapolate(_counts(*traced[1]), _counts(*traced[2]), cfg_x.n_blocks)
        _, memory, meta = lower_cell(cfg, shape, mesh, trace=False, **kw)
        depth = "extrapolated"
    memory = {**memory, **{k: v for (sec, k), v in flat.items() if sec == "memory"}}
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_tag(mesh),
        **meta,
        "depth": depth,
        "memory": memory,
        "cost_analysis_raw": {k: v for (sec, k), v in flat.items()
                              if sec == "cost_analysis_raw"},
        "collectives": {"by_kind": {k: v for (sec, k), v in flat.items() if sec == "by_kind"},
                        "counts": {k: v for (sec, k), v in flat.items() if sec == "counts"},
                        "total_bytes": flat[("collectives", "total_bytes")]},
        "hlo_ops": {k: v for (sec, k), v in flat.items() if sec == "hlo_ops"},
    }
    if probes:
        probe = {}
        for nb in (1, 2):
            if nb in traced and not cfg_x.remainder_layers:
                pt = traced[nb][0]
            else:
                pt, _, _ = lower_cell(cfg, shape, mesh, probe_blocks=nb, **kw)
            probe[f"blocks{nb}"] = {"flops": float(pt.flops),
                                    "bytes_accessed": float(pt.bytes_accessed),
                                    "collective_bytes": pt.collectives()["total_bytes"]}
        rec["probe"] = probe
    rec["trace_s"] = round(time.time() - t0, 2)
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        name = f"{cfg.name}_{shape.name}_{rec['mesh']}{tag}.json"
        (OUT_DIR / name).write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--full-depth", action="store_true",
                    help="trace every layer (slow) instead of extrapolating from 2 probes")
    args = ap.parse_args(argv)

    pods = []
    if not args.multi_pod_only:
        pods.append(False)
    if not args.single_pod_only:
        pods.append(True)

    if args.all:
        todo = [(c, s) for c, s, skip in cells() if not skip]
    else:
        todo = [(get_config(args.arch), SHAPES[args.shape])]

    failures = []
    for multi_pod in pods:
        mesh = make_production_mesh(multi_pod=multi_pod)
        for cfg, shape in todo:
            label = f"{cfg.name} x {shape.name} @ {mesh_tag(mesh)}"
            try:
                probes = args.probes and mesh.ndim == 2
                rec = run_cell(cfg, shape, mesh, probes=probes, full_depth=args.full_depth)
                print(
                    f"OK   {label}: trace {rec['trace_s']}s, "
                    f"temp/dev {rec['memory']['temp_bytes_per_device']/2**30:.2f} GiB, "
                    f"args/dev {rec['memory']['argument_bytes_per_device']/2**30:.2f} GiB, "
                    f"coll {rec['collectives']['total_bytes']/2**30:.2f} GiB",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001  (a cell's failure is reported, the rest run)
                failures.append((label, repr(e)))
                print(f"FAIL {label}: {e!r}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for label, err in failures:
            print(" ", label, err)
        raise SystemExit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
