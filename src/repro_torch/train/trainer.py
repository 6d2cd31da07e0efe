"""Training step: microbatched gradient accumulation and the optimizer
update (the port of the JAX package's ``train/trainer.py``).

``make_train_step`` builds the step the training launcher
(``launch/train.py``) runs.  With ``n_micro > 1`` the batch is split
into ``n_micro`` microbatches along its first axis, run one after
another (live activation memory is one microbatch's), and their
gradients summed into buffers of ``accum_dtype`` (float32), never into
``p.grad`` in the parameters' dtype; loss and gradients are then divided
by ``n_micro``.  With ``n_micro == 1`` the gradients stay in the
parameters' dtype, as JAX's are.  The update runs per reference leaf
(``models/convert.py:reference_leaves``): the layers of a block position
are stacked into the reference's tensor, updated and written back.
"""
from __future__ import annotations

import torch

from ..models.convert import reference_leaves
from ..models.layers import upcast


def value_and_grad(lm, batch, n_micro: int = 1, accum_dtype=torch.float32):
    """``(loss, grads)`` of ``lm.loss`` over ``batch``: grads in
    ``lm.parameters()`` order, in the parameters' dtype for ``n_micro ==
    1``, else the mean over the microbatches accumulated in
    ``accum_dtype``.  Turns the parameters' gradients on."""
    lm.requires_grad_(True)
    params = list(lm.parameters())
    if n_micro == 1:
        loss = lm.loss(batch)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss.detach(), list(grads)
    batch = {k: torch.as_tensor(v, device=lm.device) for k, v in batch.items()}
    n = next(iter(batch.values())).shape[0]
    if n % n_micro:
        raise ValueError(f"batch of {n} does not split into {n_micro} microbatches")
    mb = n // n_micro
    loss = torch.zeros((), dtype=_wide(lm), device=lm.device)
    acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in params]
    for i in range(n_micro):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l_i = lm.loss(part)
        grads = torch.autograd.grad(l_i, params, materialize_grads=True)
        loss = loss + l_i.detach()
        for a, g in zip(acc, grads):
            a.add_(g.to(accum_dtype))
        del grads
    return loss / n_micro, [a.div_(n_micro) for a in acc]


def stack_leaf(tensors, stacked: bool):
    """The reference's leaf of one group of the port's tensors."""
    return torch.stack(tensors) if stacked else tensors[0]


class TrainStep:
    """``step(opt_state, batch, step) -> (opt_state, metrics)``: the loss
    and gradients of ``batch`` (:func:`value_and_grad`), then the
    optimizer's update of ``lm``'s parameters in place (:meth:`apply`).
    ``opt_state`` is :func:`init_state` or a restored one (the reference's
    leaf order), ``step`` the global step (AdamW's bias correction),
    ``metrics`` ``{"loss", "grad_norm"}`` (0-d tensors; the norm over
    every leaf in float32, float64 for a float64 model)."""

    def __init__(self, lm, optimizer, n_micro: int = 1, accum_dtype=torch.float32):
        self.lm, self.optimizer = lm, optimizer
        self.n_micro, self.accum_dtype = n_micro, accum_dtype
        names = [n for n, _ in lm.named_parameters()]
        index = {n: i for i, n in enumerate(names)}
        self.groups = [([index[r] for r in rows], stacked)
                       for _, rows, stacked in reference_leaves(lm.cfg, names)]

    def __call__(self, opt_state, batch, step):
        loss, grads = value_and_grad(self.lm, batch, self.n_micro, self.accum_dtype)
        opt_state, gnorm = self.apply(opt_state, grads, step)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    @torch.no_grad()
    def apply(self, opt_state, grads, step):
        """The update from ``grads`` (``lm.parameters()`` order), one
        reference leaf at a time: stacked, updated, written back.  Returns
        ``(new opt_state, the gradients' global norm)``."""
        params = list(self.lm.parameters())
        sq = torch.zeros((), dtype=_wide(self.lm), device=self.lm.device)
        new_state = []
        for (idx, stacked), s in zip(self.groups, opt_state):
            for i in idx:           # row by row: no float32 copy of a whole leaf
                sq = sq + torch.sum(torch.square(upcast(grads[i])))
            g = stack_leaf([grads[i] for i in idx], stacked)
            p = stack_leaf([params[i] for i in idx], stacked)
            newp, s = self.optimizer.update_leaf(g, s, p, step)
            new_state.append(s)
            for b, i in enumerate(idx):
                params[i].copy_(newp[b] if stacked else newp)
            del g, p, newp
        return new_state, torch.sqrt(sq)


def make_train_step(lm, optimizer, n_micro: int = 1, accum_dtype=torch.float32):
    """The reference's factory: a :class:`TrainStep` over ``lm`` (whose
    parameters it updates in place)."""
    return TrainStep(lm, optimizer, n_micro, accum_dtype)


def init_state(optimizer, lm) -> list[dict]:
    """The optimizer's fresh state for ``lm``'s reference leaves (their
    shapes, dtypes and device; nothing is stacked)."""
    named = dict(lm.named_parameters())
    out = []
    for _, rows, stacked in reference_leaves(lm.cfg, list(named)):
        p = named[rows[0]].detach()
        out.append(optimizer.init_leaf(p.expand(len(rows), *p.shape) if stacked else p))
    return out


def _wide(lm):
    return torch.promote_types(lm.act_dtype, torch.float32)


def pick_microbatches(cfg, shape, n_dp: int) -> int:
    """Keep ~<=8k tokens per device per microbatch (activation budget)."""
    tokens_per_dev = shape.seq_len * shape.global_batch // max(n_dp, 1)
    n = max(1, tokens_per_dev // 8192)
    # must divide the per-step batch count
    while shape.global_batch % (n or 1):
        n -= 1
    return max(n, 1)
