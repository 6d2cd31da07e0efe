"""Serving launcher: batched greedy generation over any selectable decoder-only
arch (the port of the JAX package's ``launch/serve.py``), on the card
unless ``--device cpu``, on a ``(1, 1)`` mesh of one process as the
reference's launcher runs on its host mesh.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
      --batch 4 --prompt-len 32 --max-new 16 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import all_configs, get_config
from ..core.queries_torch import resolve_device
from ..models import LM
from ..models.model import shard_lm
from ..serve.engine import LMServer
from .mesh import mesh_of_one
from .train import reduced_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=sorted(all_configs()))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.encoder_layers or cfg.frontend != "none":
        raise SystemExit(
            "the serve launcher targets decoder-only archs; use examples/ for "
            "enc-dec and vlm flows"
        )
    device = resolve_device(args.device)
    with mesh_of_one(device) as mesh:            # the reference's host mesh
        lm = shard_lm(LM(cfg, device=device), mesh)
        server = LMServer(lm)
        rng = np.random.default_rng(0)
        prompts = rng.integers(
            0, cfg.vocab, (args.batch, args.prompt_len)
        ).astype(np.int32)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        out = server.generate(prompts, max_new=args.max_new)
        dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"generated {out.shape} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s on {device})")
    print("first sequence:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
