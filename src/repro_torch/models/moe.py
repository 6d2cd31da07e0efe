"""Mixture-of-experts FFN on one device, with the reference's routing and
its Switch drop (the port of the JAX package's ``models/moe.py``).

Routing: a softmax over ``x @ router`` in float32 (float64 in a float64
model) at the caller's matmul precision.  PyTorch's default is full
float32; with TF32 on (``torch.backends.cuda.matmul.allow_tf32``)
experts flip against the CPU, so callers that compare routes keep it
off.  Then the top ``moe_top_k`` experts in ``jax.lax.top_k``'s order (a
stable sort: the lower index first on ties), the weights renormalised
and cast to the activation dtype.

Dispatch, per chunk of ``TOKEN_CHUNK`` tokens (shrunk to a divisor of the
token count): the ``(token, slot)`` assignments are sorted stably by
expert, each expert's first row is found by ``searchsorted``, and an
assignment at position ``C = capacity(...)`` or later of its expert is
dropped (it writes a sentinel row and contributes nothing: the token
keeps its residual).  The experts run as batched products over ``(E, C,
D)``.  Each token's output is the sum of its slots' contributions in slot
order, gathered, not scattered: two runs on the card give the same bits.

On one device every expert is local and there is no combine across
shards.  On a mesh (DTensor inputs) the reference's expert parallelism
runs (``_expert_parallel``): its ``shard_map`` body under ``local_map``,
the experts split over ``model``, each rank routing the tokens of its
data shard (chunks and capacity counted on them), tokens for another
rank's experts to the sentinel, the partial outputs summed over
``model``; ``dropped`` then counts this rank's drops (its tokens in its
experts), and the sum over the ranks is the layer's.
Arctic's dense-residual SwiGLU is added after the experts, outside.

Training rematerialises every layer (``LM.loss``): a layer's forward runs
again in the backward pass with ``count_drops`` off, so ``dropped``
counts each assignment once per forward.
``aux_loss`` is the reference's Switch load-balancing loss; like the
reference, the LM's loss does not add it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ref import top_k
from .layers import MLP, Init, upcast
from .sharding import DTensor, Partial, Replicate, Shard, shard_map_compat

TOKEN_CHUNK = 8192


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a chunk of ``n_tokens``: ``capacity_factor *
    n_tokens * top_k / E``, rounded up to a multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * n_tokens * cfg.moe_top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def shard_drops(cfg, router, x, n_data: int, n_model: int,
                token_chunk: int | None = None) -> list[list[int]]:
    """The drops the expert-parallel MoE makes on each ``(data shard,
    model shard)`` of a ``(n_data, n_model)`` mesh: the reference's routing
    (float32 softmax, ``lax.top_k``'s order) on each data shard's rows of
    ``x`` ``(B, S, D)`` (all of them on every data shard when ``B`` does not
    divide), in chunks of ``token_chunk`` (``TOKEN_CHUNK``) shrunk to a
    divisor of the shard's tokens, each model shard's experts past
    ``capacity`` of a chunk counted.  An oracle for tests and the chip
    check, plain tensors only."""
    b, s, d = x.shape
    rows = b // n_data if b % n_data == 0 else b
    e_l = cfg.n_experts // n_model
    out = []
    for i in range(n_data):
        xs = x[i * rows:(i + 1) * rows] if rows != b else x
        t = xs.shape[0] * s
        gates = torch.softmax(upcast(xs.reshape(t, d)) @ upcast(router), dim=-1)
        _, tope = top_k(gates, cfg.moe_top_k)
        chunk = min(token_chunk or TOKEN_CHUNK, t)
        while t % chunk:
            chunk -= 1
        c = capacity(cfg, chunk)
        counts = torch.stack([torch.bincount(tope[j:j + chunk].reshape(-1),
                                             minlength=cfg.n_experts)
                              for j in range(0, t, chunk)])       # (chunks, E)
        over = (counts - c).clamp(min=0)
        out.append([int(over[:, j * e_l:(j + 1) * e_l].sum()) for j in range(n_model)])
    return out


class MoE(nn.Module):
    """``(B, S, D) -> (B, S, D)`` over ``n_experts`` SwiGLU experts of
    hidden ``moe_dff`` (``d_ff`` if 0).  ``dropped`` counts the assignments
    that found their expert full since it was last zeroed (a device
    tensor: reading it waits for the card), while ``count_drops`` is on
    (off during a rematerialised forward)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.moe_dff or cfg.d_ff, cfg.n_experts
        self.router = init.normal(d, e)
        self.w1 = init.normal(e, d, f)
        self.w3 = init.normal(e, d, f)
        self.w2 = init.normal(e, f, d)
        if cfg.dense_residual:
            self.dense = MLP(d, cfg.d_ff, init)
        self.dropped = torch.zeros((), dtype=torch.int64, device=init.device)
        self.count_drops = True

    def route(self, xf, router=None):
        """Tokens ``(T, D)`` -> ``(weights (T, K) in xf's dtype, experts (T,
        K) int64)`` (through ``router``, the layer's own unless given)."""
        router = self.router if router is None else router
        gates = torch.softmax(upcast(xf) @ upcast(router), dim=-1)
        topw, tope = top_k(gates, self.cfg.moe_top_k)
        return (topw / topw.sum(dim=-1, keepdim=True)).to(xf.dtype), tope

    def _dispatch(self, xc, ec, wc, c, w1, w3, w2, lo=0):
        """One chunk: tokens ``(T, D)``, experts and weights ``(T, K)``, ``c``
        slots per expert, through the experts ``lo .. lo + E_l - 1`` whose
        weights are ``w1``, ``w3``, ``w2`` (``E_l`` rows).  An assignment
        to another expert goes to the sentinel expert ``E_l`` and adds
        nothing (on one device every expert is local).  Returns ``(T, D)``."""
        t, d = xc.shape
        k = ec.shape[1]
        e = w1.shape[0]
        flat_e = ec.reshape(-1)
        local = (flat_e >= lo) & (flat_e < lo + e)
        fe = torch.where(local, flat_e - lo, e)               # sentinel expert e
        order = torch.sort(fe, stable=True).indices           # (token, slot) order kept
        sfe = fe[order]
        first = torch.searchsorted(sfe, torch.arange(e + 1, device=xc.device))
        pos = torch.empty_like(order)
        pos[order] = torch.arange(t * k, device=xc.device) - first[sfe]
        full = pos >= c
        drop = full | ~local
        if self.count_drops:
            self.dropped += (full & local).sum()
        slot = torch.where(drop, c, pos)                      # row c: the sentinel
        buf = torch.zeros(e + 1, c + 1, d, dtype=xc.dtype, device=xc.device)
        buf[fe, slot] = xc.repeat_interleave(k, dim=0)
        buf = buf[:e, :c]
        h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
        ob = torch.bmm(h, w2)                                 # (E_l, C, D)
        contrib = ob[fe.clamp(max=e - 1), slot.clamp(max=c - 1)] * wc.reshape(-1, 1)
        contrib = torch.where(drop[:, None], torch.zeros((), dtype=xc.dtype,
                                                         device=xc.device), contrib)
        contrib = contrib.reshape(t, k, d)
        out = contrib[:, 0]
        for j in range(1, k):                                 # slot order
            out = out + contrib[:, j]
        return out

    def _experts(self, x, router, w1, w3, w2, lo=0):
        """Route ``(B, S, D)`` tokens and run them through the experts from
        ``lo`` whose weights are given, in ``TOKEN_CHUNK``-token chunks
        (shrunk to a divisor of ``B * S``), ``capacity`` counted on one
        chunk."""
        b, s, d = x.shape
        t = b * s
        xf = x.reshape(t, d)
        topw, tope = self.route(xf, router)
        chunk = min(TOKEN_CHUNK, t)
        while t % chunk:
            chunk -= 1
        c = capacity(self.cfg, chunk)
        out = torch.cat([self._dispatch(xf[i:i + chunk], tope[i:i + chunk],
                                        topw[i:i + chunk], c, w1, w3, w2, lo)
                         for i in range(0, t, chunk)])
        return out.reshape(b, s, d)

    def _expert_parallel(self, x):
        """The reference's ``shard_map`` body under ``local_map``: the router
        replicated, the experts split over ``model``, the tokens split over
        the data dims where the batch divides (else replicated); each rank
        routes its tokens in chunks of its own and runs its experts, tokens
        for the others' to the sentinel; the partial outputs are summed over
        ``model`` (the reference's ``psum``)."""
        mesh = x.device_mesh
        n_dp = len(mesh.mesh_dim_names) - 1
        model = mesh.mesh_dim_names.index("model")
        ways = 1
        for m in range(n_dp):
            ways *= mesh.size(m)
        split = x.shape[0] % ways == 0
        batch = [Shard(0) if split else Replicate()] * n_dp
        data_grad = [Partial() if split else Replicate()] * n_dp
        experts = [Replicate()] * n_dp + [Shard(0)]

        def body(router, w1, w3, w2, xt):
            lo = mesh.get_coordinate()[model] * w1.shape[0]
            return self._experts(xt, router, w1, w3, w2, lo)

        run = shard_map_compat(
            body, mesh,
            in_placements=([Replicate()] * (n_dp + 1), experts, experts, experts,
                           batch + [Replicate()]),
            out_placements=batch + [Partial()],
            in_grad_placements=(data_grad + [Partial()], data_grad + [Shard(0)],
                                data_grad + [Shard(0)], data_grad + [Shard(0)],
                                batch + [Partial()]))
        out = run(self.router, self.w1, self.w3, self.w2, x)
        return out.redistribute(mesh, batch + [Replicate()])

    def aux_loss(self, x):
        """The Switch load-balancing loss of ``(B, S, D)`` tokens: ``E *
        sum(f * P)``, ``f`` the share of top-k assignments and ``P`` the mean
        gate of each expert (float32; float64 in a float64 model)."""
        e = self.cfg.n_experts
        gates = torch.softmax(upcast(x.reshape(-1, x.shape[-1])) @ upcast(self.router), dim=-1)
        _, tope = top_k(gates, self.cfg.moe_top_k)
        onehot = F.one_hot(tope, e).to(gates.dtype).sum(dim=1)     # (T, E)
        return e * torch.sum(onehot.mean(dim=0) * gates.mean(dim=0))

    def forward(self, x):
        if isinstance(x, DTensor):
            out = self._expert_parallel(x)
        else:
            out = self._experts(x, self.router, self.w1, self.w3, self.w2)
        if self.cfg.dense_residual:
            out = out + self.dense(x)
        return out
