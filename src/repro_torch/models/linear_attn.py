"""Chunked gated linear attention, the engine shared by RWKV6 and Mamba
(the port of the JAX package's ``models/linear_attn.py``).

Both sequence mixers obey one matrix-state recurrence per head

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: dk x dv)
    y_t = r_t S_{t-1} (+ (r_t . (u * k_t)) v_t   [RWKV6's bonus])

with ``w_t`` in (0, 1): a per-channel data-dependent decay for RWKV6, a
per-head scalar decay for Mamba's SSD form.  Within a chunk of ``c``
positions the decays become cumulative products (a log-space cumsum) and
the intra-chunk part is a masked ``(c x c)`` product; across chunks the
``(dk x dv)`` state is carried by a plain loop.  (The reference solves
that carry with an associative scan, a lever of its XLA compile; the
function is the same.)  Everything runs in float32 (float64 for float64
inputs) and the output is cast back to ``r``'s dtype, as in the reference.

The reference's fault (ROADMAP C.9), not copied: it runs the chunk its
caller names, and every config names 64, where ``exp(-la_inc)`` reaches
``e^160`` and overflows float32 (non-finite outputs at full width); it
also asserts ``S % chunk == 0``.  Here the chunk is at most
``GLA_MAX_CHUNK`` and the tail is padded with steps that leave the state
as it was, so any ``S`` runs and the result is finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import upcast

LOG_DECAY_BOUND = 2.5
# a chunk's decay factors reach exp(LOG_DECAY_BOUND * chunk); at 32
# positions that is e^80, inside float32 (whose largest value is e^88.7)
GLA_MAX_CHUNK = 32


def bounded_log_decay(raw):
    """Map raw decay logits to ``log w`` in ``(-LOG_DECAY_BOUND, 0)``, in
    float32."""
    return -LOG_DECAY_BOUND * torch.sigmoid(upcast(raw))


def chunked_gla(r, k, v, log_w, *, chunk: int, u=None, state0=None):
    """Chunked gated linear attention.

    ``r``, ``k``: ``(B, S, H, dk)``; ``v``: ``(B, S, H, dv)``; ``log_w``:
    ``(B, S, H, dk)`` or ``(B, S, H, 1)`` (a scalar decay); ``u``: ``(H,
    dk)``, RWKV6's bonus, or None; ``state0``: ``(B, H, dk, dv)`` or None
    (zeros).  The chunk is ``min(chunk, GLA_MAX_CHUNK, S)``; the sequence
    is padded to a multiple of it with ``r = k = v = 0``, ``log_w = 0``
    (decay 1, nothing added: the state passes unchanged) and the padded
    outputs are dropped.  Returns ``(y (B, S, H, dv) in r's dtype, final
    state (B, H, dk, dv) in float32)``."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    c = max(1, min(chunk, GLA_MAX_CHUNK, s))
    n = -(-s // c)
    pad = n * c - s

    def blocks(x):
        x = upcast(x)
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(b, n, c, h, x.shape[-1])

    rc, kc, vc, lw = blocks(r), blocks(k), blocks(v), blocks(log_w)
    la_inc = lw.cumsum(dim=2)                          # inclusive log cumprod
    # exclusive: the inclusive sum one step back (not la_inc - lw, whose
    # rounding would make A_{t-1} / A_{t-1} differ from 1)
    la_exc = F.pad(la_inc[:, :, :-1], (0, 0, 0, 0, 1, 0))
    a_last = la_inc[:, :, -1]                          # (B, n, H, dkw)
    rq = rc * torch.exp(la_exc)                        # r_t * A_{t-1}
    ks = kc * torch.exp(-la_inc)                       # k_s / A_s
    kl = kc * torch.exp(a_last[:, :, None] - la_inc)   # k_s * A_last / A_s

    # intra-chunk: strict lower-triangular (s < t) attention
    scores = torch.einsum("bnthd,bnshd->bnhts", rq, ks)
    mask = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(mask, scores, torch.zeros((), device=r.device))
    y = torch.einsum("bnhts,bnshv->bnthv", scores, vc)
    if u is not None:
        bonus = torch.einsum("bnthd,hd,bnthd->bnth", rc, upcast(u), kc)
        y = y + bonus[..., None] * vc

    # inter-chunk: S_i = diag(a_i) S_{i-1} + B_i, carried chunk by chunk
    b_chunk = torch.einsum("bnshd,bnshv->bnhdv", kl, vc)
    a_chunk = torch.exp(a_last)[..., None]             # (B, n, H, dkw, 1)
    state = (torch.zeros(b, h, dk, dv, dtype=rc.dtype, device=r.device)
             if state0 is None else upcast(state0))
    inter = []
    for i in range(n):
        inter.append(torch.einsum("bthd,bhdv->bthv", rq[:, i], state))
        state = a_chunk[:, i] * state + b_chunk[:, i]
    y = (y + torch.stack(inter, dim=1)).reshape(b, n * c, h, dv)[:, :s]
    return y.to(r.dtype), state


def gla_decode(r, k, v, log_w, state, u=None):
    """The exact one-token recurrence.  ``r``, ``k``: ``(B, H, dk)``;
    ``v``: ``(B, H, dv)``; ``log_w``: ``(B, H, dk or 1)``; ``state``:
    ``(B, H, dk, dv)`` float32.  Returns ``(y (B, H, dv) in r's dtype,
    new state)``."""
    r32, k32, v32 = upcast(r), upcast(k), upcast(v)
    w = torch.exp(upcast(log_w))
    y = torch.einsum("bhd,bhdv->bhv", r32, state)
    if u is not None:
        y = y + torch.einsum("bhd,hd,bhd->bh", r32, upcast(u), k32)[..., None] * v32
    new_state = w[..., None] * state + k32[..., :, None] * v32[..., None, :]
    return y.to(r.dtype), new_state


def gla_reference(r, k, v, log_w, *, u=None, state0=None):
    """The sequential oracle (tests): ``gla_decode`` step by step."""
    b, s, h, dk = r.shape
    state = (torch.zeros(b, h, dk, v.shape[-1], dtype=upcast(r).dtype, device=r.device)
             if state0 is None else state0)
    ys = []
    for t in range(s):
        y, state = gla_decode(r[:, t], k[:, t], v[:, t], log_w[:, t], state, u=u)
        ys.append(y)
    return torch.stack(ys, dim=1), state
