"""The LM (the port of the JAX package's ``models/model.py``): logits over
a whole sequence, prefill into a cache and one-token decode, for every
family of ``configs/``: dense, local:global, MoE, RWKV6, the Mamba
hybrid, the encoder-decoder and the VLM's patch front end.

    lm = LM(cfg, device="cuda")                 # seeded init on the card
    logits = lm(tokens)                         # (B, S, padded_vocab)
    last, cache = lm.prefill(tokens, cache_len)
    logits, cache = lm.decode_step(token, cache, pos)

An encoder-decoder takes ``frames=`` (``(B, S_enc, D)`` stub frame
embeddings) in ``forward`` and ``prefill``; the VLM takes
``patch_embeds=`` (``(B, P, D)``), projected by ``patch_proj`` and put
before the tokens, so its positions, ``cache_len`` and decode positions
count the ``P`` patches.  Decode needs neither: the encoder's keys and
values and the patches' keys live in the cache.

The reference's ``sharding.py``, ``abstract_params``, ``param_pspecs`` and
``input_specs`` are not ported: they describe XLA's dry run and mesh
partitioning, which one card does not have (ROADMAP A.8).  Training
(``loss_fn``, MoE's ``aux_loss``) is ROADMAP A.8.2.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.queries_torch import resolve_device
from .layers import Embedding, Init
from .transformer import Block, layer_plan

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


class LM(nn.Module):
    """Embedding, the encoder (``cfg.encoder_layers`` non-causal attention
    blocks) and ``patch_proj`` where the config has them, ``cfg.n_layers``
    decoder blocks and the output logits, on ``device`` (``cuda`` unless
    named; raises without a card), weights and activations in the
    config's dtype.  Weights are drawn from ``generator`` (a
    ``torch.Generator`` on that device, seeded with 0 when not given);
    ``empty=True`` allocates them undrawn, for a state that is loaded next
    (``models/convert.py``)."""

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
        cross = cfg.encoder_layers > 0
        self.layers = nn.ModuleList(Block(cfg, kind, ffn, init, cross=cross)
                                    for kind, ffn in plan)
        if cross:
            self.encoder = nn.ModuleList(Block(cfg, "attn", "dense", init, causal=False)
                                         for _ in range(cfg.encoder_layers))
        if cfg.frontend == "patch_stub":
            # the frozen projection standing in for the ViT's output head
            self.patch_proj = init.normal(cfg.d_model, cfg.d_model)

    def _inputs(self, tokens, frames, patch_embeds):
        """The decoder's input ``(B, [P +] S, D)`` and the encoder's output
        (None without an encoder)."""
        cfg = self.cfg
        enc_out = None
        if cfg.encoder_layers:
            if frames is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames=")
            enc_out = torch.as_tensor(frames, device=self.device).to(self.act_dtype)
            for layer in self.encoder:
                enc_out = layer(enc_out)
        x = self.embed.embed(torch.as_tensor(tokens, device=self.device))
        if cfg.frontend == "patch_stub":
            if patch_embeds is None:
                raise ValueError(f"{cfg.name} has a patch front end: pass patch_embeds=")
            pe = torch.as_tensor(patch_embeds, device=self.device).to(x.dtype)
            x = torch.cat([(pe @ self.patch_proj).to(x.dtype), x], dim=1)
        return x, enc_out

    @torch.no_grad()
    def forward(self, tokens, *, frames=None, patch_embeds=None):
        """Train-mode logits ``(B, [P +] S, padded_vocab)`` of a ``(B, S)``
        batch (with ``frames`` or ``patch_embeds`` where the config needs
        them)."""
        x, enc_out = self._inputs(tokens, frames, patch_embeds)
        for layer in self.layers:
            x = layer(x, enc_out=enc_out)
        return self.embed.logits(x)

    def new_cache(self, batch: int, cache_len: int, cross_len: int = 0) -> list[dict]:
        """Zeroed caches at their final size for ``cache_len`` positions (and
        ``cross_len`` encoder positions): one dict per layer
        (``Block.cache_defs``)."""
        return [{name: torch.zeros(shape, device=self.device,
                                   dtype=(torch.promote_types(self.act_dtype, torch.float32)
                                          if f32 else self.act_dtype))
                 for name, (shape, f32) in layer.cache_defs(batch, cache_len,
                                                            cross_len).items()}
                for layer in self.layers]

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int | None = None, *, frames=None,
                patch_embeds=None):
        """Forward over a ``(B, S)`` prompt (after ``P`` patches for the
        VLM), keeping every layer's state in caches allocated at their
        final size (``cache_len`` positions, ``[P +] S`` unless given).
        Returns ``(logits of the last position (B, 1, V), cache)``."""
        x, enc_out = self._inputs(tokens, frames, patch_embeds)
        b, s = x.shape[:2]
        cache = self.new_cache(b, s if cache_len is None else cache_len,
                               0 if enc_out is None else enc_out.shape[1])
        for layer, c in zip(self.layers, cache):
            x = layer(x, c, enc_out=enc_out)
        return self.embed.logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token, cache, pos):
        """One token ``(B, 1)`` at positions ``pos`` ``(B,)`` (counting the
        VLM's patches).  Returns ``(logits (B, 1, V), cache)``; the cache
        is updated in place."""
        x = self.embed.embed(torch.as_tensor(token, device=self.device))
        pos = torch.as_tensor(pos, device=self.device)
        for layer, c in zip(self.layers, cache):
            x = layer.decode(x, c, pos)
        return self.embed.logits(x), cache
