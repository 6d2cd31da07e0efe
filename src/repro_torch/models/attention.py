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
from .sharding import (DTensor, axes_for_mesh, constrain, local_region,
                       merge_last, placements_for, proj, shard_map_compat, split_last)

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
        q = split_last(proj(x, self.wq), cfg.n_heads, cfg.hd)
        k = split_last(proj(x, self.wk), cfg.n_kv_heads, cfg.hd)
        v = split_last(proj(x, self.wv), cfg.n_kv_heads, cfg.hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        q, k = rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)
        return (constrain(q, None, ("fsdp", None, "tp", None)),
                constrain(k, None, ("fsdp", None, None, None)),
                constrain(v, None, ("fsdp", None, None, None)))

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
        out = merge_last(torch.cat(outs, dim=1))
        return proj(out, self.wo), k, v

    def decode(self, x, cache_k, cache_v, pos, *, window=0):
        """One token ``(B, 1, D)`` at positions ``pos`` ``(B,)`` against the
        cache ``(B, S_cache, Hk, hd)``, written in place: a ring of
        ``S_cache`` slots when ``window``, else the full context."""
        cfg = self.cfg
        b = x.shape[0]
        s_cache = cache_k.shape[1]
        q, k1, v1 = self.project_qkv(x, pos[:, None])
        slot = pos % s_cache if window else pos
        if isinstance(cache_k, DTensor):
            logical = cache_logical(window)
            write_at(cache_k, logical, slot, k1[:, 0])
            write_at(cache_v, logical, slot, v1[:, 0])
        else:
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
        return proj(merge_last(out), self.wo)

    def encode_kv(self, enc_out):
        """Cross-attention keys and values ``(B, S_enc, Hk, hd)`` of the
        encoder's output: k-norm when ``qk_norm``, no rotary embedding."""
        cfg = self.cfg
        b, s, _ = enc_out.shape
        k = split_last(proj(enc_out, self.wk), cfg.n_kv_heads, cfg.hd)
        v = split_last(proj(enc_out, self.wv), cfg.n_kv_heads, cfg.hd)
        if cfg.qk_norm:
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        return k, v

    def cross(self, x, enc_k, enc_v):
        """Cross-attention of ``(B, Sq, D)`` against the encoder's keys and
        values: q-norm when ``qk_norm``, no rotary embedding, no mask."""
        cfg = self.cfg
        b, sq, _ = x.shape
        q = split_last(proj(x, self.wq), cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
        mask = torch.ones(1, sq, enc_k.shape[1], dtype=torch.bool, device=x.device)
        out = sdpa_block(q, enc_k, enc_v, mask)
        return proj(merge_last(out), self.wo)


def cache_logical(window) -> tuple:
    """The reference's logical axes of a layer's key or value cache: a
    local layer's ring is replicated along its slots, a global layer's
    cache is split along the sequence over ``tp`` ('seq')."""
    return ("fsdp", None, None, None) if window else ("fsdp", "seq", None, None)


def _seq_offset(mesh, n_local: int, sharded: bool) -> int:
    """The first global position of this rank's slice of a cache dim of
    ``n_local`` local slots split over the model dim."""
    if not sharded:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index("model")] * n_local


def write_at(cache, logical, slot, value):
    """``cache[b, slot[b]] = value[b]`` for a ``(B, S, Hk, hd)`` DTensor
    cache: each rank writes the rows whose slot lies in its slice of the
    sequence (``local_map``: DTensor has no sharding rule for an indexed
    write).  The cache is updated in place."""
    seq = logical[1] is not None

    def body(c, sl, val):
        n = c.shape[1]
        rel = sl.long() - _seq_offset(cache.device_mesh, n, seq)
        keep = (rel >= 0) & (rel < n)
        idx = rel.clamp(0, n - 1)
        bidx = torch.arange(c.shape[0], device=c.device)
        c[bidx, idx] = torch.where(keep[:, None, None], val, c[bidx, idx])
        return c

    local_region(body, (cache, slot, value), (logical, ("fsdp",), ("fsdp", None, None)),
                 (logical, tuple(cache.shape)))


def write_prefix(cache, logical, values):
    """``cache[:, :S] = values`` (``(B, S, Hk, hd)``, the sequence
    replicated) for a DTensor cache: each rank copies the positions of its
    slice.  The cache is updated in place."""
    seq = logical[1] is not None

    def body(c, val):
        n = c.shape[1]
        off = _seq_offset(cache.device_mesh, n, seq)
        m = min(max(val.shape[1] - off, 0), n)
        c[:, :m] = val[:, off:off + m]
        return c

    local_region(body, (cache, values), (logical, ("fsdp", None, None, None)),
                 (logical, tuple(cache.shape)))


def sdpa_block(q, k, v, mask):
    """``(B, cq, H, hd)`` x ``(B, Skv, Hk, hd)`` -> ``(B, cq, H, hd)``.  KV
    heads are repeated to the full head count; scores and softmax in
    float32 (products of the inputs, summed in float32, as the reference's
    ``preferred_element_type``), the weights cast back to ``q``'s dtype.
    ``mask`` is ``(B or 1, cq, Skv)``.

    On a mesh the repeated keys and values are constrained to the
    reference's ``("fsdp", None, "tp", None)`` and the block runs on each
    rank's batch rows and heads (``local_map``: DTensor has no sharding
    rule for the batched product of a batch dim split over two mesh
    dims)."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if not isinstance(q, DTensor):
        return _sdpa(q, k, v, mask)
    heads = ("fsdp", None, "tp", None)
    k, v = constrain(k, None, heads), constrain(v, None, heads)
    mesh = q.device_mesh
    pq = placements_for(mesh, axes_for_mesh(mesh), heads, q.shape)
    pm = (placements_for(mesh, axes_for_mesh(mesh), ("fsdp", None, None), mask.shape)
          if isinstance(mask, DTensor) else None)
    return shard_map_compat(_sdpa, mesh, (pq, pq, pq, pm), pq)(q, k, v, mask)


def _sdpa(q, k, v, mask):
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", upcast(q), upcast(k)) / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, None], NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
