"""End-to-end training launcher (the port of the JAX package's
``launch/train.py``).

Runs real steps on the card (or the CPU with ``--device cpu``): data
pipeline -> microbatched train step -> periodic async checkpoints, with
crash-safe restart (resumes from the latest complete snapshot, including
pipeline state), on a ``(1, 1)`` mesh of one process as the reference's
launcher runs on its host mesh (DTensor parameters, the plain step's ops
bit for bit).  The state is saved in the reference's layout
(``{"params": <its tree>, "opt": <its leaf order>}``, ``extra`` the step
and the pipeline), so a float32 checkpoint of either package resumes in
the other.  Like the reference's launcher it always trains with AdamW;
``train.optimizer.pick_for`` chooses for the reference's dry run.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 50 --batch 8 --seq 256 --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from ..configs.base import all_configs, get_config
from ..core.queries_torch import resolve_device
from ..data.pipeline import PipelineState, TokenPipeline
from ..models import LM, arrays_from_params, params_from_arrays
from ..models.model import VLM_PATCH_TOKENS, shard_batch, shard_lm
from ..models.sharding import full
from ..train import optimizer as opt_mod
from ..train.checkpoint import CheckpointManager
from ..train.trainer import init_state, make_train_step, place_state
from .mesh import mesh_of_one


def reduced_config(cfg, *, layers=2, d_model=128, vocab=512):
    """Shrink an arch config to a CPU-trainable size, same family wiring."""
    sb = cfg.superblock
    n_layers = max(layers * sb, sb) + cfg.remainder_layers
    kw = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
        d_ff=d_model * 3,
        vocab=vocab,
        head_dim=d_model // 4,
        dtype="float32",
        chunk_q=64,
        la_chunk=16,
    )
    if cfg.n_experts:
        kw.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                  moe_dff=d_model * 3)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2)
    if cfg.family == "rwkv":
        kw.update(rwkv_head_dim=d_model // 4)
    if cfg.attn_every:
        kw.update(mamba_d_state=16, mamba_head_dim=d_model // 4)
    return dataclasses.replace(cfg, **kw)


def build_batch(pipe, cfg, shape_batch, seq, *, n_patch=VLM_PATCH_TOKENS, device=None):
    """The next global batch as tensors on ``device``: ``tokens`` and
    ``labels``, ``frames`` ``(B, seq, D)`` for an encoder-decoder and
    ``n_patch`` ``patch_embeds`` for the VLM (float32 normal draws of a
    fixed seed, as the reference's)."""
    device = resolve_device(device)
    b = pipe.global_batch(shape_batch)
    batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    if cfg.encoder_layers:
        rng = np.random.default_rng(0)
        batch["frames"] = torch.from_numpy(
            rng.normal(0, 1, (shape_batch, seq, cfg.d_model)).astype(np.float32)).to(device)
    if cfg.frontend == "patch_stub":
        rng = np.random.default_rng(0)
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (shape_batch, n_patch, cfg.d_model)).astype(np.float32)).to(device)
    return batch


def save_state(mgr, step, lm, opt_state, pipe) -> None:
    """Checkpoint ``step`` in the reference's layout, written on the
    manager's thread (``save_async``): ``params`` (its tree), ``opt`` (its
    leaf order), ``extra`` the step and the pipeline state.  DTensors are
    saved whole."""
    state = {k: full(v) for k, v in lm.state_dict().items()}
    opt = [{k: full(v) for k, v in s.items()} for s in opt_state]
    tree = {"params": arrays_from_params(lm.cfg, state), "opt": opt}
    mgr.save_async(step, tree, extra={"step": step, "pipeline": pipe.state.as_dict()})


def restore_state(mgr, cfg, pipe, device=None, step=None):
    """``(lm, opt_state, step)`` from the manager's checkpoint ``step`` (the
    latest unless given), the pipeline's state set from it; None if there
    is no checkpoint."""
    device = resolve_device(device)
    tree, extra = mgr.restore(step, device=device)
    if tree is None:
        return None
    lm = LM(cfg, device=device, empty=True)
    lm.load_state_dict(params_from_arrays(cfg, tree["params"]))
    pipe.state = PipelineState.from_dict(extra["pipeline"])
    return lm, tree["opt"], extra["step"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=sorted(all_configs()))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config for CPU execution")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    device = resolve_device(args.device)

    optimizer = opt_mod.get_optimizer("adamw", lr=args.lr)
    pipe = TokenPipeline(cfg.vocab, args.seq, n_shards=1, seed=0)
    mgr = CheckpointManager(args.ckpt_dir)
    n_patch = min(VLM_PATCH_TOKENS, args.seq // 4)
    losses = []
    with mesh_of_one(device) as mesh:            # the reference's host mesh
        restored = restore_state(mgr, cfg, pipe, device)
        if restored is not None:
            lm, opt_state, start = restored
            print(f"restored step {start}")
            shard_lm(lm, mesh)
            opt_state = place_state(optimizer, lm, opt_state)
        else:
            lm = shard_lm(LM(cfg, device=device), mesh)
            opt_state = init_state(optimizer, lm)
            start = 0
        step_fn = make_train_step(lm, optimizer, args.micro)

        for step in range(start, args.steps):
            batch = shard_batch(build_batch(pipe, cfg, args.batch, args.seq, n_patch=n_patch,
                                            device=device), mesh)
            t0 = time.time()
            opt_state, metrics = step_fn(opt_state, batch, step)
            loss = float(metrics["loss"])
            losses.append(loss)
            print(
                f"step {step:4d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"{time.time()-t0:6.2f}s",
                flush=True,
            )
            if (step + 1) % args.ckpt_every == 0:
                save_state(mgr, step + 1, lm, opt_state, pipe)
        mgr.wait()
    if len(losses) > 2:
        print(f"loss: first {losses[0]:.4f} -> last {losses[-1]:.4f} "
              f"({'DECREASED' if losses[-1] < losses[0] else 'no decrease'})")
    return losses


if __name__ == "__main__":
    main()
