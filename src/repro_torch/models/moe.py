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

The reference runs the dispatch under ``shard_map`` with experts split
over a model axis and a ``psum``; one device holds every expert, so the
local range is all of them and there is no combine across shards.
Arctic's dense-residual SwiGLU is added after the experts.

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

TOKEN_CHUNK = 8192


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a chunk of ``n_tokens``: ``capacity_factor *
    n_tokens * top_k / E``, rounded up to a multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * n_tokens * cfg.moe_top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


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

    def route(self, xf):
        """Tokens ``(T, D)`` -> ``(weights (T, K) in xf's dtype, experts (T,
        K) int64)``."""
        gates = torch.softmax(upcast(xf) @ upcast(self.router), dim=-1)
        topw, tope = top_k(gates, self.cfg.moe_top_k)
        return (topw / topw.sum(dim=-1, keepdim=True)).to(xf.dtype), tope

    def _dispatch(self, xc, ec, wc, c):
        """One chunk: tokens ``(T, D)``, experts and weights ``(T, K)``, ``c``
        slots per expert.  Returns ``(T, D)``."""
        t, d = xc.shape
        k = ec.shape[1]
        e = self.cfg.n_experts
        flat_e = ec.reshape(-1)
        order = torch.sort(flat_e, stable=True).indices      # (token, slot) order kept
        sfe = flat_e[order]
        first = torch.searchsorted(sfe, torch.arange(e + 1, device=xc.device))
        pos = torch.empty_like(order)
        pos[order] = torch.arange(t * k, device=xc.device) - first[sfe]
        drop = pos >= c
        if self.count_drops:
            self.dropped += drop.sum()
        slot = torch.where(drop, c, pos)                      # row c: the sentinel
        buf = torch.zeros(e, c + 1, d, dtype=xc.dtype, device=xc.device)
        buf[flat_e, slot] = xc.repeat_interleave(k, dim=0)
        buf = buf[:, :c]
        h = F.silu(torch.bmm(buf, self.w1)) * torch.bmm(buf, self.w3)
        ob = torch.bmm(h, self.w2)                            # (E, C, D)
        contrib = ob[flat_e, slot.clamp(max=c - 1)] * wc.reshape(-1, 1)
        contrib = torch.where(drop[:, None], torch.zeros((), dtype=xc.dtype,
                                                         device=xc.device), contrib)
        contrib = contrib.reshape(t, k, d)
        out = contrib[:, 0]
        for j in range(1, k):                                 # slot order
            out = out + contrib[:, j]
        return out

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
        b, s, d = x.shape
        t = b * s
        xf = x.reshape(t, d)
        topw, tope = self.route(xf)
        chunk = min(TOKEN_CHUNK, t)
        while t % chunk:
            chunk -= 1
        c = capacity(self.cfg, chunk)
        out = torch.cat([self._dispatch(xf[i:i + chunk], tope[i:i + chunk],
                                        topw[i:i + chunk], c)
                         for i in range(0, t, chunk)])
        out = out.reshape(b, s, d)
        if self.cfg.dense_residual:
            out = out + self.dense(x)
        return out
