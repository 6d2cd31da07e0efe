"""Optimizers: AdamW and Adafactor (factored second moments), the port of
the JAX package's ``train/optimizer.py``.

Adafactor is the memory-sane choice for the >40B architectures (arctic,
qwen3-moe, jamba): second moments factor into row/col running means over
the last two axes, so optimizer state is O(sum of dims) instead of O(params).

Both work on the reference's leaves: each parameter of the reference's
tree is one tensor (``models/convert.py:reference_leaves``; the trainer
stacks a block position's ``n_blocks`` layers into it), and the state is
a list of per-leaf dicts in the reference's leaf order, so a checkpoint's
``opt`` is the reference's.  Adafactor decides what to factor, and clips,
over the whole stacked leaf, as the reference does: a norm scale of two
blocks is a ``(2, D)`` leaf with row and column state.

The formulas keep the reference's order of operations: float32 state and
arithmetic (float64 for a float64 model, a witness), the new parameter
``p32 - step - lr * wd * p32`` cast back to the parameter's dtype, AdamW's
bias correction ``1 - b ** t`` in float32 from the global step the caller
passes (``t = step + 1``, so a resumed run goes on correcting where it
stopped).  ``torch.optim.AdamW`` is not used: its foreach and fused paths
round differently.

``state_specs`` is the reference's: the logical axes of each leaf's state
from the leaf's own (a list of logical tuples in leaf order, the stack
axis included), the state sharded exactly like the parameter it tracks:
AdamW's ``m`` and ``v`` as the leaf, Adafactor's ``row`` without its last
axis and ``col`` without its second last, its ``v`` as the leaf.  Like
the reference it decides row/col by the number of axes, not by
``factored``: a leaf with a dim of 1 (a norm scale of one block) gets
``v`` state and row/col specs (``train.trainer.init_state`` places such a
``v`` like its leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _wide(dtype):
    """The dtype of the state and arithmetic: float32, float64 for a
    float64 leaf."""
    return torch.promote_types(dtype, torch.float32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init_leaf: Callable       # p -> state dict
    update_leaf: Callable     # (g, s, p, step) -> (new p, new s)
    state_specs: Callable     # leaf logical axes (list) -> state logical axes (list)

    def init(self, params):
        """The state of a list of leaves (reference order)."""
        return [self.init_leaf(p) for p in params]

    def update(self, grads, state, params, step):
        """``(new params, new state)`` of lists of leaves; nothing is changed
        in place."""
        pairs = [self.update_leaf(g, s, p, step) for g, s, p in zip(grads, state, params)]
        return [p for p, _ in pairs], [s for _, s in pairs]


def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, wd: float = 0.01) -> Optimizer:
    def init_leaf(p):
        z = torch.zeros(p.shape, dtype=_wide(p.dtype), device=p.device)
        return {"m": z, "v": z.clone()}

    def update_leaf(g, s, p, step):
        wide = _wide(p.dtype)
        t = torch.as_tensor(step, device=p.device).to(wide) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        g = g.to(wide)
        m = b1 * s["m"] + (1 - b1) * g
        v = b2 * s["v"] + (1 - b2) * g * g
        stp = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        p32 = p.to(wide)
        newp = p32 - stp - lr * wd * p32
        return newp.to(p.dtype), {"m": m, "v": v}

    def state_specs(pspecs):
        return [{"m": tuple(sp), "v": tuple(sp)} for sp in pspecs]

    return Optimizer(init_leaf, update_leaf, state_specs)


def adafactor(lr: float = 1e-4, decay: float = 0.99,
              eps: float = 1e-30, clip: float = 1.0) -> Optimizer:
    def factored(p) -> bool:
        return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1

    def init_leaf(p):
        wide = _wide(p.dtype)
        if factored(p):
            return {"row": torch.zeros(p.shape[:-1], dtype=wide, device=p.device),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=wide,
                                       device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=wide, device=p.device)}

    def update_leaf(g, s, p, step):
        # the reference's expressions, computed in place where a temporary
        # of the leaf's size can go (the same roundings in the same order)
        g = g.to(_wide(p.dtype))
        g2 = (g * g).add_(eps)
        if factored(p):
            row = decay * s["row"] + (1 - decay) * g2.mean(dim=-1)
            col = decay * s["col"] + (1 - decay) * g2.mean(dim=-2)
            del g2
            rfac = row / torch.clamp(row.mean(dim=-1, keepdim=True), min=eps)
            v = rfac[..., None] * col[..., None, :]
            u = v.add_(eps).rsqrt_().mul_(g)        # g * rsqrt(v + eps)
            new_s = {"row": row, "col": col}
        else:
            v = decay * s["v"] + (1 - decay) * g2
            del g2
            u = g * torch.rsqrt(v + eps)
            new_s = {"v": v}
        del g
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u.div_(torch.clamp(rms / clip, min=1.0))     # update clipping
        newp = p.to(u.dtype, copy=True).sub_(u.mul_(lr))    # p32 - lr * u
        return newp.to(p.dtype), new_s

    def state_specs(pspecs):
        out = []
        for sp in pspecs:
            st = tuple(sp)
            if len(st) >= 2:
                out.append({"row": st[:-1], "col": st[:-2] + st[-1:]})
            else:
                out.append({"v": st})
        return out

    return Optimizer(init_leaf, update_leaf, state_specs)


def get_optimizer(name: str, lr: float = 1e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(name)


def pick_for(cfg) -> str:
    """Adafactor above ~40B total params (HBM headroom), AdamW otherwise."""
    total, _ = cfg.params_count()
    return "adafactor" if total > 40e9 else "adamw"
