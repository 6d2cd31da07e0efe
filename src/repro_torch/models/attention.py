"""Attention of the LM: GQA with RoPE, qk-norm, sliding windows and
cross-attention (the port of the JAX package's ``models/attention.py``).

Prefill and training run q-chunked (``cfg.chunk_q``): the score matrix is
built one query block at a time, so a long prefill never holds an S x S
tensor.  Local layers mask scores outside the window.  (The reference's
``local_slice_opt`` computes the same function over a sliced K/V; it is a
lever of its XLA compile, and the port always masks.)

Decode attends one token against a cache: local layers keep a ring of
``min(window, cache_len)`` positions (slot ``pos % S_cache``), global
layers the whole context.  An encoder's self-attention is not causal;
a decoder's cross-attention attends every encoder position of keys and
values computed once (``encode_kv``), without rotary embedding.  Scores
and softmax run in float32, the weights cast back to the activation
dtype, as in the reference.  This is plain PyTorch: the reference's
attention is jnp, not a Pallas kernel.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Init, rms_norm, rope, upcast

NEG = -2.0e38


class Attention(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.hd
        self.wq = init.normal(d, cfg.n_heads * hd)
        self.wk = init.normal(d, cfg.n_kv_heads * hd)
        self.wv = init.normal(d, cfg.n_kv_heads * hd)
        self.wo = init.normal(cfg.n_heads * hd, d)
        if cfg.qk_norm:
            self.q_norm = init.ones(hd)
            self.k_norm = init.ones(hd)

    def project_qkv(self, x, positions):
        """``(B, S, D)`` -> q ``(B, S, H, hd)``, k and v ``(B, S, Hk, hd)``,
        qk-norm before the rotary embedding at ``positions`` ``(B or 1, S)``."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ self.wq).view(b, s, cfg.n_heads, cfg.hd)
        k = (x @ self.wk).view(b, s, cfg.n_kv_heads, cfg.hd)
        v = (x @ self.wv).view(b, s, cfg.n_kv_heads, cfg.hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v

    def forward(self, x, *, window=0, causal=True):
        """Full-sequence (train/prefill) attention, q-chunked, causal
        unless ``causal=False`` (an encoder).  Returns ``(out (B, S, D), k,
        v)`` so that prefill can keep the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device)
        q, k, v = self.project_qkv(x, pos[None])
        cq = min(cfg.chunk_q, s)
        while s % cq:  # the largest divisor of S not above chunk_q
            cq -= 1
        outs = []
        for start in range(0, s, cq):
            pos_q = pos[start:start + cq]
            mask = torch.ones(1, pos_q.shape[0], s, dtype=torch.bool, device=x.device)
            if causal:
                mask &= pos_q[None, :, None] >= pos[None, None, :]
            if window:
                mask &= pos_q[None, :, None] - pos[None, None, :] < window
            outs.append(sdpa_block(q[:, start:start + cq], k, v, mask))
        out = torch.cat(outs, dim=1).reshape(b, s, cfg.n_heads * cfg.hd)
        return out @ self.wo, k, v

    def decode(self, x, cache_k, cache_v, pos, *, window=0):
        """One token ``(B, 1, D)`` at positions ``pos`` ``(B,)`` against the
        cache ``(B, S_cache, Hk, hd)``, written in place: a ring of
        ``S_cache`` slots when ``window``, else the full context."""
        cfg = self.cfg
        b = x.shape[0]
        s_cache = cache_k.shape[1]
        q, k1, v1 = self.project_qkv(x, pos[:, None])
        slot = pos % s_cache if window else pos
        bidx = torch.arange(b, device=x.device)
        cache_k[bidx, slot] = k1[:, 0]
        cache_v[bidx, slot] = v1[:, 0]
        kpos = torch.arange(s_cache, device=x.device)[None, :]
        if window:
            # a ring slot holds the newest position congruent to it
            stored = pos[:, None] - (pos[:, None] - kpos) % s_cache
            mask = (stored >= 0) & (stored <= pos[:, None])
        else:
            mask = kpos <= pos[:, None]
        out = sdpa_block(q, cache_k, cache_v, mask[:, None, :])
        return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ self.wo

    def encode_kv(self, enc_out):
        """Cross-attention keys and values ``(B, S_enc, Hk, hd)`` of the
        encoder's output: k-norm when ``qk_norm``, no rotary embedding."""
        cfg = self.cfg
        b, s, _ = enc_out.shape
        k = (enc_out @ self.wk).view(b, s, cfg.n_kv_heads, cfg.hd)
        v = (enc_out @ self.wv).view(b, s, cfg.n_kv_heads, cfg.hd)
        if cfg.qk_norm:
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        return k, v

    def cross(self, x, enc_k, enc_v):
        """Cross-attention of ``(B, Sq, D)`` against the encoder's keys and
        values: q-norm when ``qk_norm``, no rotary embedding, no mask."""
        cfg = self.cfg
        b, sq, _ = x.shape
        q = (x @ self.wq).view(b, sq, cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
        mask = torch.ones(1, sq, enc_k.shape[1], dtype=torch.bool, device=x.device)
        out = sdpa_block(q, enc_k, enc_v, mask)
        return out.reshape(b, sq, cfg.n_heads * cfg.hd) @ self.wo


def sdpa_block(q, k, v, mask):
    """``(B, cq, H, hd)`` x ``(B, Skv, Hk, hd)`` -> ``(B, cq, H, hd)``.  KV
    heads are repeated to the full head count; scores and softmax in
    float32 (products of the inputs, summed in float32, as the reference's
    ``preferred_element_type``), the weights cast back to ``q``'s dtype.
    ``mask`` is ``(B or 1, cq, Skv)``."""
    hd = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", upcast(q), upcast(k)) / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, None], NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
