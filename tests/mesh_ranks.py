"""Rank bodies of the mesh tests (``tests/test_torch_mesh.py``): the LM's
sharded step on a ``("data", "model")`` mesh of gloo ranks, returned as
NumPy for the parent to hold against one device.  Spawned ranks import
this module in a fresh interpreter, so it imports neither JAX nor the JAX
package."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import make_host_mesh, use_mesh
from repro_torch.launch.train import reduced_config
from repro_torch.models import LM
from repro_torch.models.model import shard_batch, shard_lm
from repro_torch.models.moe import MoE
from repro_torch.train.trainer import value_and_grad


def _numpy(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().cpu().numpy()


def lm_step(cfg, batch: dict, mesh=None, device="cpu", n_micro: int = 1) -> dict:
    """Logits of ``forward``, then ``value_and_grad``'s loss and every
    gradient (by parameter name) and the MoE layers' drop counts, of the
    seed-0 LM of ``cfg`` on ``batch`` (NumPy), sharded on ``mesh`` when
    given."""
    lm = LM(cfg, device=device)
    names = [n for n, _ in lm.named_parameters()]
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    if mesh is not None:
        shard_lm(lm, mesh)
        batch = shard_batch(batch, mesh)
    with use_mesh(mesh) if mesh is not None else _null():
        logits = lm(batch["tokens"], frames=batch.get("frames"),
                    patch_embeds=batch.get("patch_embeds"))
        fwd_drops = [int(m.dropped) for m in lm.modules() if isinstance(m, MoE)]
        loss, grads = value_and_grad(lm, batch, n_micro)
    return {"logits": _numpy(logits), "loss": float(_numpy(loss)),
            "grads": {n: _numpy(g) for n, g in zip(names, grads)},
            "drops": fwd_drops}


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def mesh_config(arch: str, layers: int = 1, **overrides):
    """The reduced config of ``arch`` at ``layers`` superblocks
    (``launch.train.reduced_config``) with ``overrides`` replaced."""
    return dataclasses.replace(reduced_config(get_config(arch), layers=layers), **overrides)


def lm_step_rank(group, arch: str, mesh_shape, batch: dict, n_micro: int = 1,
                 overrides: dict | None = None):
    """One rank of :func:`lm_step` on a ``mesh_shape`` host mesh over
    :func:`mesh_config`."""
    torch.manual_seed(0)
    cfg = mesh_config(arch, **(overrides or {}))
    mesh = make_host_mesh(*mesh_shape, device_type=group.device.type)
    return lm_step(cfg, batch, mesh, device=str(group.device), n_micro=n_micro)


def moe_step(cfg, tree: dict, x, mesh, device="cpu", token_chunk=None) -> dict:
    """The MoE FFN of ``cfg`` with the weights ``tree`` (NumPy, the
    reference's layout) on ``x`` ``(B, S, D)``, expert-parallel on
    ``mesh``: the full output and this rank's drop count."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe as tmoe
    from repro_torch.models.convert import LOGICAL
    from repro_torch.models.layers import Init
    from repro_torch.models.sharding import axes_for_mesh, placements_for

    if token_chunk is not None:
        tmoe.TOKEN_CHUNK = token_chunk
    mod = tmoe.MoE(cfg, Init(None, torch.device(device), torch.float32, empty=True))
    axes = axes_for_mesh(mesh)
    for name, value in tree.items():
        t = torch.as_tensor(np.asarray(value), device=device)
        placed = placements_for(mesh, axes, LOGICAL["ffn"]["moe"][name], t.shape)
        setattr(mod, name, torch.nn.Parameter(distribute_tensor(t, mesh, placed),
                                              requires_grad=False))
    xt = distribute_tensor(torch.as_tensor(x, device=device), mesh,
                           placements_for(mesh, axes, ("fsdp", None, None), x.shape))
    with use_mesh(mesh), torch.no_grad():
        out = mod(xt)
    return {"out": _numpy(out), "drops": int(mod.dropped),
            "coord": list(mesh.get_coordinate())}


def jobs_rank(group, mesh_shape, jobs: list):
    """Every job of a list on one rank of a ``mesh_shape`` host mesh:
    ``("lm", arch, batch, overrides)`` (:func:`lm_step`) or ``("moe", cfg,
    tree, x, token_chunk)`` (:func:`moe_step`)."""
    torch.manual_seed(0)
    mesh = make_host_mesh(*mesh_shape, device_type=group.device.type)
    out = []
    for job in jobs:
        if job[0] == "lm":
            _, arch, batch, overrides = job
            out.append(lm_step(mesh_config(arch, **overrides), batch, mesh,
                               device=str(group.device)))
        else:
            _, cfg, tree, x, token_chunk = job
            out.append(moe_step(cfg, tree, x, mesh, device=str(group.device),
                                token_chunk=token_chunk))
    return out


MOE_CHUNK = 16          # 2 x 16 tokens per data shard of moe_case: two chunks


def moe_case():
    """A small MoE (8 experts, top 2) whose router favours experts 0 and 1,
    so that the shipped capacity factor (1.25) drops assignments, and its
    ``(4, 16, 64)`` input: ``(cfg, weights (NumPy, the reference's
    layout), x)``."""
    from repro_torch.configs.base import ModelConfig

    cfg = ModelConfig(name="t-moe", family="moe", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=4, d_ff=96, vocab=100, n_experts=8, moe_top_k=2,
                      moe_dff=80, dtype="float32")
    rng = np.random.default_rng(31)
    tree = {"router": rng.normal(0, 64 ** -0.5, (64, 8)),
            "w1": rng.normal(0, 64 ** -0.5, (8, 64, 80)),
            "w3": rng.normal(0, 64 ** -0.5, (8, 64, 80)),
            "w2": rng.normal(0, 80 ** -0.5, (8, 80, 64))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    tree["router"][:, :2] += 0.6            # experts 0 and 1 take most tokens
    x = rng.normal(0, 1, (4, 16, 64)).astype(np.float32)
    return cfg, tree, x


def lm_batch(cfg, b: int = 4, s: int = 32, seed: int = 7) -> dict:
    """Tokens (labels the same), and frames for an encoder-decoder, drawn
    from ``seed`` (float64 frames for a float64 config)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"] = batch["tokens"]
    wide = np.float64 if cfg.dtype == "float64" else np.float32
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(wide)
    return batch


def rel_err(a, b) -> float:
    """``|a - b| / |b|`` in the Frobenius norm."""
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-300))


def mesh_of_one_rank(group, arch: str, dtype: str, n_micro: int, batch: dict):
    """The reduced ``arch``'s AdamW step (in ``dtype``, ``n_micro``
    microbatches) twice on one rank under deterministic algorithms: plain,
    and with DTensor parameters on a ``(1, 1)`` mesh.  Returns both losses
    and parameters (NumPy, as float64) and their ``FlopCounterMode``
    counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import init_state, make_train_step

    torch.use_deterministic_algorithms(True)
    cfg = mesh_config(arch, dtype=dtype)
    mesh = make_host_mesh(1, 1, device_type=group.device.type)
    out = {}
    for name in ("plain", "dtensor"):
        lm = LM(cfg, device=str(group.device))
        b = {k: torch.as_tensor(v, device=group.device) for k, v in batch.items()}
        if name == "dtensor":
            shard_lm(lm, mesh)
            b = shard_batch(b, mesh)
        opt = get_optimizer("adamw", lr=3e-4)
        state = init_state(opt, lm)
        step = make_train_step(lm, opt, n_micro)
        with use_mesh(mesh) if name == "dtensor" else _null(), \
                FlopCounterMode(display=False) as fc:
            state, metrics = step(state, b, 0)
        local = [(p.to_local() if hasattr(p, "to_local") else p).detach() for p in lm.parameters()]
        out[name] = {"loss": metrics["loss"].detach().view(torch.int16 if metrics["loss"].dtype
                                                            == torch.bfloat16 else
                                                            metrics["loss"].dtype).cpu().numpy(),
                     "params": [p.float().cpu().numpy() for p in local],
                     "bits": [p.contiguous().view(torch.uint8).cpu().numpy() for p in local],
                     "flops": fc.get_total_flops()}
    return out
