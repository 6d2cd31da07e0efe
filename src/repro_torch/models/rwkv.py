"""RWKV6 (Finch): the time mix with its data-dependent decay and the
channel mix (the port of the JAX package's ``models/rwkv.py``).

A token shift feeds the r/k/v/g/w projections through learned per-channel
mixing constants; the decay ``w_t`` is data-dependent per channel, a
low-rank (LoRA) head bounded by ``bounded_log_decay``; ``u`` is the
current token's bonus.  A sequence runs through the chunked GLA engine,
one token through the exact recurrence, carrying the last input of the
shift and the matrix state.  Plain PyTorch: the reference is jnp, not a
Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Init, rms_norm
from .linear_attn import bounded_log_decay, chunked_gla, gla_decode
from .sharding import constrain, merge_last, proj, split_last

DECAY_LORA = 64


def _token_shift(x, prev):
    """The ``x_{t-1}`` stream: ``(B, S, D)`` shifted right by one, position
    0 taking ``prev`` ``(B, D)``."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _mix(x, shifted, mu):
    return x + (shifted - x) * torch.sigmoid(mu)


class TimeMix(nn.Module):
    """The time mix: ``(B, S, D) -> (B, S, D)``, with ``H = D /
    rwkv_head_dim`` heads."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        self.mix = init.zeros(5, d)                 # r, k, v, g, w shifts
        self.wr = init.normal(d, d)
        self.wk = init.normal(d, d)
        self.wv = init.normal(d, d)
        self.wg = init.normal(d, d)
        self.wo = init.normal(d, d)
        self.w0 = init.zeros(d)
        self.w_lora_a = init.normal(d, DECAY_LORA)
        self.w_lora_b = init.normal(DECAY_LORA, d)
        self.u = init.zeros(d // hd, hd)
        self.ln_out = init.ones(d)

    def _project(self, x, shifted):
        """r, k, v (``(..., H, hd)``), the gate and the bounded log decay of
        the mixed streams."""
        hd = self.cfg.rwkv_head_dim
        h = x.shape[-1] // hd
        xr, xk, xv, xg, xw = (_mix(x, shifted, self.mix[i]) for i in range(5))
        r = split_last(proj(xr, self.wr), h, hd)
        k = split_last(proj(xk, self.wk), h, hd)
        v = split_last(proj(xv, self.wv), h, hd)
        g = F.silu(proj(xg, self.wg))
        w_raw = self.w0 + proj(proj(xw, self.w_lora_a), self.w_lora_b)
        return r, k, v, g, split_last(bounded_log_decay(w_raw), h, hd)

    def _out(self, y, g):
        """Per-head RMS norm (a ones weight in ``y``'s dtype), the gate,
        ``ln_out`` and the output projection."""
        cfg = self.cfg
        y = rms_norm(y, torch.ones(cfg.rwkv_head_dim, dtype=y.dtype, device=y.device),
                     cfg.norm_eps)
        y = merge_last(y) * g
        return proj(rms_norm(y, self.ln_out, cfg.norm_eps), self.wo)

    def forward(self, x, prev=None, state0=None):
        """``(B, S, D)``, the shift's previous input ``prev`` ``(B, D)``
        (zeros if None) and the state ``state0`` (zeros if None).  Returns
        ``(out, x[:, -1], final state (B, H, hd, hd) float32)``."""
        if prev is None:
            prev = torch.zeros_like(x[:, 0])
        r, k, v, g, log_w = self._project(x, _token_shift(x, prev))
        r = constrain(r, None, ("fsdp", None, "tp", None))
        k = constrain(k, None, ("fsdp", None, "tp", None))
        y, state = chunked_gla(r, k, v, log_w, chunk=self.cfg.la_chunk, u=self.u,
                               state0=state0)
        return self._out(y, g), x[:, -1], state

    def decode(self, x1, prev, state):
        """One token ``(B, D)``.  Returns ``(out (B, D), x1, new state)``."""
        r, k, v, g, log_w = self._project(x1, prev)
        y, state = gla_decode(r, k, v, log_w, state, u=self.u)
        return self._out(y, g), x1, state


class ChannelMix(nn.Module):
    """The channel mix (RWKV's FFN): ``sigmoid(x_r wr) * (relu(x_k wk)^2
    wv)`` over token-shifted inputs."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.mix = init.zeros(2, d)                 # k, r shifts
        self.wk = init.normal(d, f)
        self.wv = init.normal(f, d)
        self.wr = init.normal(d, d)

    def _mixed(self, x, shifted):
        xk = _mix(x, shifted, self.mix[0])
        xr = _mix(x, shifted, self.mix[1])
        k = torch.square(F.relu(proj(xk, self.wk)))
        return torch.sigmoid(proj(xr, self.wr)) * proj(k, self.wv)

    def forward(self, x, prev=None):
        """``(B, S, D)`` -> ``(out, x[:, -1])``."""
        if prev is None:
            prev = torch.zeros_like(x[:, 0])
        return self._mixed(x, _token_shift(x, prev)), x[:, -1]

    def decode(self, x1, prev):
        """One token ``(B, D)`` -> ``(out, x1)``."""
        return self._mixed(x1, prev), x1
