"""Mamba in the SSD form, for Jamba's hybrid layers (the port of the JAX
package's ``models/mamba.py``).

An in-projection to ``(x, z)`` with expansion, a causal depthwise conv on
``x``, data-dependent ``dt``/``B``/``C`` heads, the ``D`` skip and the
``silu(z)`` gate; the SSD form's scalar decay per head per step runs
through the same chunked GLA engine as RWKV6 (``C`` as r, ``B`` as k, the
conv output as v).  Plain PyTorch: the reference is jnp, not a Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Init
from .linear_attn import bounded_log_decay, chunked_gla, gla_decode

CONV_K = 4


class Mamba(nn.Module):
    """``(B, S, D) -> (B, S, D)`` with ``di = mamba_expand * D`` inner
    channels in ``di / mamba_head_dim`` heads of state ``mamba_d_state``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        di = cfg.mamba_expand * d
        h = di // cfg.mamba_head_dim
        n = cfg.mamba_d_state
        self.in_proj = init.normal(d, 2 * di)              # x, z
        self.conv_w = init.normal(CONV_K, di, scale=0.5)
        self.wB = init.normal(d, h * n)
        self.wC = init.normal(d, h * n)
        self.w_dt = init.normal(d, h)
        self.dt_bias = init.zeros(h)
        self.D = init.ones(h)
        self.out_proj = init.normal(di, d)

    def _heads(self, x, xin):
        """C (as r), B (as k), the conv output as v ``(..., H, hd)`` and the
        scalar log decay ``(..., H, 1)``."""
        cfg = self.cfg
        lead = x.shape[:-1]
        h = cfg.mamba_expand * cfg.d_model // cfg.mamba_head_dim
        bm = (x @ self.wB).reshape(lead + (h, cfg.mamba_d_state))
        cm = (x @ self.wC).reshape(lead + (h, cfg.mamba_d_state))
        v = xin.reshape(lead + (h, cfg.mamba_head_dim))
        log_a = bounded_log_decay(x @ self.w_dt + self.dt_bias).reshape(lead + (h, 1))
        return cm, bm, v, log_a

    def _out(self, y, v, z):
        """The ``D`` skip, the ``silu(z)`` gate and the out-projection."""
        y = y + self.D[:, None] * v
        return (y.reshape(z.shape) * F.silu(z)) @ self.out_proj

    def forward(self, x, conv_prev=None, state0=None):
        """``(B, S, D)``; ``conv_prev`` ``(B, CONV_K - 1, di)`` (zeros if
        None), ``state0`` ``(B, H, d_state, hd)`` (zeros if None).  Returns
        ``(out, the conv's last CONV_K - 1 inputs, final state float32)``."""
        b, s, _ = x.shape
        di = self.cfg.mamba_expand * self.cfg.d_model
        xin, z = (x @ self.in_proj).split(di, dim=-1)
        if conv_prev is None:
            conv_prev = torch.zeros(b, CONV_K - 1, di, dtype=x.dtype, device=x.device)
        xp = torch.cat([conv_prev, xin], dim=1)
        # the taps summed in the reference's order, so that bf16 rounds alike
        xin = F.silu(sum(xp[:, j:j + s] * self.conv_w[j] for j in range(CONV_K)))
        cm, bm, v, log_a = self._heads(x, xin)
        y, state = chunked_gla(cm, bm, v, log_a, chunk=self.cfg.la_chunk, state0=state0)
        return self._out(y, v, z), xp[:, -(CONV_K - 1):], state

    def decode(self, x1, conv_prev, state):
        """One token ``(B, D)``.  Returns ``(out (B, D), new conv inputs,
        new state)``."""
        di = self.cfg.mamba_expand * self.cfg.d_model
        xin, z = (x1 @ self.in_proj).split(di, dim=-1)
        xp = torch.cat([conv_prev, xin[:, None]], dim=1)          # (B, CONV_K, di)
        xin = F.silu(sum(xp[:, j] * self.conv_w[j] for j in range(CONV_K)))
        cm, bm, v, log_a = self._heads(x1, xin)
        y, state = gla_decode(cm, bm, v, log_a, state)
        return self._out(y, v, z), xp[:, 1:], state
