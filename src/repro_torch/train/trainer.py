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

On a mesh (parameters turned into DTensors by ``models.model.shard_lm``,
run inside ``launch.mesh.use_mesh``) the same code runs on DTensors:
each gradient is redistributed to its parameter's placements, the
optimizer state is placed by ``optimizer.state_specs`` (``init_state``),
and microbatch ``i`` is each rank's ``i``-th slice of its own batch rows
(on a mesh of one, the rows of one device).
"""
from __future__ import annotations

import torch

from ..models.convert import reference_leaves, reference_logical
from ..models.layers import upcast
from ..models.sharding import DTensor, axes_for_mesh, empty_like_placed, placements_for


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
        return _replicated(loss.detach()), _placed_like(grads, params)
    batch = {k: torch.as_tensor(v, device=lm.device) for k, v in batch.items()}
    n = _local(next(iter(batch.values()))).shape[0]
    if n % n_micro:
        raise ValueError(f"batch of {n} does not split into {n_micro} microbatches")
    mb = n // n_micro
    loss = torch.zeros((), dtype=_wide(lm), device=lm.device)
    acc = [torch.zeros_like(p, dtype=accum_dtype) if isinstance(p, DTensor) else
           torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in params]
    for i in range(n_micro):
        part = {k: _rows(v, i * mb, (i + 1) * mb) for k, v in batch.items()}
        l_i = lm.loss(part)
        grads = _placed_like(torch.autograd.grad(l_i, params, materialize_grads=True), params)
        loss = loss + _replicated(l_i.detach())
        for a, g in zip(acc, grads):
            a.add_(g.to(accum_dtype))
        del grads
    return loss / n_micro, [a.div_(n_micro) for a in acc]


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _rows(t, lo, hi):
    """Rows ``lo:hi`` of a batch tensor; of each rank's own rows for a
    DTensor (no data moves)."""
    if not isinstance(t, DTensor):
        return t[lo:hi]
    return DTensor.from_local(t.to_local()[lo:hi], t.device_mesh, t.placements,
                              run_check=False)


def _replicated(t):
    """A DTensor loss summed and given to every rank; a plain one as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed_like(grads, params) -> list:
    """Each gradient redistributed to its parameter's placements."""
    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(g, DTensor) and g.placements != p.placements else g
            for g, p in zip(grads, params)]


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
                sq = sq + _replicated(torch.sum(torch.square(upcast(grads[i]))))
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
    shapes, dtypes and device; nothing is stacked).  For DTensor
    parameters each state tensor is a zeroed DTensor placed by
    ``optimizer.state_specs`` (a state whose specs do not name it, an
    unfactored Adafactor ``v``, is placed like its leaf)."""
    named = dict(lm.named_parameters())
    leaves = reference_leaves(lm.cfg, list(named))
    first = named[leaves[0][1][0]]
    if isinstance(first, DTensor):
        return _sharded_state(optimizer, lm.cfg, named, leaves, first.device_mesh)
    out = []
    for _, rows, stacked in leaves:
        p = named[rows[0]].detach()
        out.append(optimizer.init_leaf(p.expand(len(rows), *p.shape) if stacked else p))
    return out


def place_state(optimizer, lm, state) -> list[dict]:
    """A state of full tensors (``init_state``'s layout, a restored
    checkpoint's ``opt``) on ``lm``'s mesh, each tensor placed as
    :func:`init_state` places it (every rank keeps its shard)."""
    named = dict(lm.named_parameters())
    leaves = reference_leaves(lm.cfg, list(named))
    first = named[leaves[0][1][0]]
    return _sharded_state(optimizer, lm.cfg, named, leaves, first.device_mesh, state)


def _sharded_state(optimizer, cfg, named, leaves, mesh, values=None) -> list[dict]:
    from torch.distributed.tensor import distribute_tensor

    axes = axes_for_mesh(mesh)
    logical = [reference_logical(cfg, path) for path, _, _ in leaves]
    specs = optimizer.state_specs(logical)
    out = []
    for (path, rows, stacked), lg, spec in zip(leaves, logical, specs):
        p = named[rows[0]]
        shape = ((len(rows),) if stacked else ()) + tuple(p.shape)
        meta = optimizer.init_leaf(torch.empty(shape, dtype=p.dtype, device="meta"))
        state = {}
        for key, t in meta.items():
            placed = placements_for(mesh, axes, spec.get(key, lg), t.shape)
            if values is None:
                state[key] = empty_like_placed(t.shape, t.dtype, mesh, placed,
                                               p.to_local().device).zero_()
            else:
                v = values[len(out)][key]
                state[key] = distribute_tensor(v.to(p.to_local().device), mesh, placed)
        out.append(state)
    return out


def _wide(lm):
    return torch.promote_types(lm.act_dtype, torch.float32)


def data_ways(mesh) -> int:
    """The number of data-parallel shards of a mesh (the product of its
    'pod' and 'data' dims)."""
    n = 1
    for name in axes_for_mesh(mesh).dp:
        n *= mesh.size(mesh.mesh_dim_names.index(name))
    return n


def pick_microbatches(cfg, shape, n_dp: int) -> int:
    """Keep ~<=8k tokens per device per microbatch (activation budget);
    ``n_dp`` is the mesh's ``data_ways``."""
    tokens_per_dev = shape.seq_len * shape.global_batch // max(n_dp, 1)
    n = max(1, tokens_per_dev // 8192)
    # must divide the per-step batch count
    while shape.global_batch % (n or 1):
        n -= 1
    return max(n, 1)
