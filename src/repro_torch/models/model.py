"""The dense LM (the port of the JAX package's ``models/model.py`` for the
dense families): logits over a whole sequence, prefill into a cache and
one-token decode.

    lm = LM(cfg, device="cuda")                 # seeded init on the card
    logits = lm(tokens)                         # (B, S, padded_vocab)
    last, cache = lm.prefill(tokens, cache_len)
    logits, cache = lm.decode_step(token, cache, pos)

The reference's ``sharding.py``, ``abstract_params``, ``param_pspecs`` and
``input_specs`` are not ported: they describe XLA's dry run and mesh
partitioning, which one card does not have (ROADMAP A.8).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.queries_torch import resolve_device
from .layers import Embedding, Init
from .transformer import Block, layer_plan

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class LM(nn.Module):
    """Embedding, ``cfg.n_layers`` blocks and the output logits, on
    ``device`` (``cuda`` unless named; raises without a card), weights and
    activations in the config's dtype.  Weights are drawn from
    ``generator`` (a ``torch.Generator`` on that device, seeded with 0
    when not given); ``empty=True`` allocates them undrawn, for a state
    that is loaded next (``models/convert.py``)."""

    def __init__(self, cfg, *, device=None, generator=None, empty=False):
        super().__init__()
        plan = layer_plan(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.act_dtype = _DTYPES[cfg.dtype]
        if generator is None and not empty:
            generator = torch.Generator(device=self.device).manual_seed(0)
        init = Init(generator, self.device, self.act_dtype, empty=empty)
        self.embed = Embedding(cfg, init)
        self.layers = nn.ModuleList(Block(cfg, kind, init) for kind, _ in plan)

    def _embed(self, tokens):
        return self.embed.embed(torch.as_tensor(tokens, device=self.device))

    @torch.no_grad()
    def forward(self, tokens):
        """Train-mode logits ``(B, S, padded_vocab)`` of a ``(B, S)`` batch."""
        x = self._embed(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.embed.logits(x)

    def new_cache(self, batch: int, cache_len: int) -> list[dict]:
        """Zeroed caches for ``cache_len`` positions: per layer ``{"k", "v"}``
        of ``(batch, slots, Hk, hd)``, a ring of ``min(local_window,
        cache_len)`` slots for a local layer."""
        cfg = self.cfg
        out = []
        for layer in self.layers:
            shape = (batch, layer.cache_len(cache_len), cfg.n_kv_heads, cfg.hd)
            out.append({name: torch.zeros(shape, dtype=self.act_dtype, device=self.device)
                        for name in ("k", "v")})
        return out

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int | None = None):
        """Forward over a ``(B, S)`` prompt, keeping every layer's keys and
        values in caches allocated at their final size (``cache_len``,
        ``S`` unless given).  Returns ``(logits of the last position (B, 1,
        V), cache)``."""
        x = self._embed(tokens)
        b, s = x.shape[:2]
        cache = self.new_cache(b, s if cache_len is None else cache_len)
        for layer, c in zip(self.layers, cache):
            x = layer(x, c)
        return self.embed.logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token, cache, pos):
        """One token ``(B, 1)`` at positions ``pos`` ``(B,)``.  Returns
        ``(logits (B, 1, V), cache)``; the cache is updated in place."""
        x = self._embed(token)
        pos = torch.as_tensor(pos, device=self.device)
        for layer, c in zip(self.layers, cache):
            x = layer.decode(x, c, pos)
        return self.embed.logits(x), cache
