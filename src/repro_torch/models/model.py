"""The LM (the port of the JAX package's ``models/model.py``): logits over
a whole sequence, prefill into a cache and one-token decode, for every
family of ``configs/``: dense, local:global, MoE, RWKV6, the Mamba
hybrid, the encoder-decoder and the VLM's patch front end.

    lm = LM(cfg, device="cuda")                 # seeded init on the card
    logits = lm(tokens)                         # (B, S, padded_vocab)
    last, cache = lm.prefill(tokens, cache_len)
    logits, cache = lm.decode_step(token, cache, pos)
    loss = lm.loss({"tokens": tokens, "labels": tokens})   # differentiable

An encoder-decoder takes ``frames=`` (``(B, S_enc, D)`` stub frame
embeddings) in ``forward`` and ``prefill``; the VLM takes
``patch_embeds=`` (``(B, P, D)``), projected by ``patch_proj`` and put
before the tokens, so its positions, ``cache_len`` and decode positions
count the ``P`` patches.  Decode needs neither: the encoder's keys and
values and the patches' keys live in the cache.

``forward``, ``prefill`` and ``decode_step`` run under ``torch.no_grad``;
``hidden`` and ``loss`` (the reference's ``hidden_forward`` and
``loss_fn``) do not, and rematerialise as the reference does: each
decoder and encoder layer and each loss chunk runs under
``torch.utils.checkpoint`` and is recomputed in the backward pass.
Parameters are built with ``requires_grad=False``; the trainer turns
them on (``train/trainer.py``).

The reference's ``sharding.py``, ``abstract_params``, ``param_pspecs`` and
``input_specs`` are not ported: they describe XLA's dry run and mesh
partitioning, which one card does not have (ROADMAP A.8).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.queries_torch import resolve_device
from .layers import Embedding, Init, mask_padded_vocab, rms_norm, upcast
from .moe import MoE
from .transformer import Block, layer_plan

# patch positions of the VLM's stub front end in the reference's cells
VLM_PATCH_TOKENS = 256
LOSS_CHUNK = 2048      # tokens per loss chunk (bounds the float32 logits buffer)

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

    def _inputs(self, tokens, frames, patch_embeds, remat=False):
        """The decoder's input ``(B, [P +] S, D)`` and the encoder's output
        (None without an encoder), each encoder layer rematerialised when
        ``remat``."""
        cfg = self.cfg
        enc_out = None
        if cfg.encoder_layers:
            if frames is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames=")
            enc_out = torch.as_tensor(frames, device=self.device).to(self.act_dtype)
            for layer in self.encoder:
                enc_out = _remat(layer, enc_out) if remat else layer(enc_out)
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

    def hidden(self, tokens, *, frames=None, patch_embeds=None):
        """The last decoder layer's output ``(B, [P +] S, D)``, before the
        final norm (the reference's ``hidden_forward``), differentiable,
        every layer rematerialised in the backward pass."""
        x, enc_out = self._inputs(tokens, frames, patch_embeds, remat=True)
        for layer in self.layers:
            x = _remat(layer, x, enc_out=enc_out)
        return x

    def loss(self, batch):
        """Next-token cross entropy of a batch (``tokens``, ``labels`` ``(B,
        S)``, and ``frames`` or ``patch_embeds`` where the config needs
        them), the reference's ``loss_fn``: float32 logits over
        ``LOSS_CHUNK``-token chunks of the ``S - 1`` predicted positions (the
        chunk shrunk to a divisor of ``S - 1``), the padded vocab masked,
        summed and divided by ``B * (S - 1)``; the VLM's over its token
        positions only.  MoE's ``aux_loss`` is not added, as in the
        reference's code."""
        cfg = self.cfg
        x = self.hidden(batch["tokens"], frames=batch.get("frames"),
                        patch_embeds=batch.get("patch_embeds"))
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        if cfg.frontend == "patch_stub":
            x = x[:, -labels.shape[1]:]            # token positions only
        x = rms_norm(x, self.embed.final_norm, cfg.norm_eps)
        w = self.embed.tok.T if cfg.tied_embeddings else self.embed.out
        b, s, _ = x.shape
        n_tok = s - 1
        chunk = min(LOSS_CHUNK, n_tok)
        while n_tok % chunk:
            chunk -= 1
        xs, tgt = x[:, :-1], labels[:, 1:]
        total = torch.zeros((), dtype=upcast(x).dtype, device=self.device)
        for i in range(0, n_tok, chunk):
            total = total + _remat(self._chunk_nll, xs[:, i:i + chunk], tgt[:, i:i + chunk], w)
        return total / (b * n_tok)

    def _chunk_nll(self, xc, tc, w):
        """Summed negative log-likelihood of one chunk: ``(B, c, D)`` states
        and ``(B, c)`` targets against the output projection ``w``."""
        lg = mask_padded_vocab(self.cfg, upcast(xc @ w))
        gold = lg.gather(-1, tc[..., None])[..., 0]
        return torch.sum(torch.logsumexp(lg, dim=-1) - gold)

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


@contextlib.contextmanager
def _drops_not_counted(moes):
    for m in moes:
        m.count_drops = False
    try:
        yield
    finally:
        for m in moes:
            m.count_drops = True


def _remat(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, rematerialised in the backward pass where
    autograd records (``torch.utils.checkpoint``, non-reentrant); the
    MoE layers of a module ``fn`` count no drops while it is recomputed."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    moes = [m for m in fn.modules() if isinstance(m, MoE)] if isinstance(fn, nn.Module) else []
    return checkpoint(fn, *args, use_reentrant=False, **kwargs,
                      context_fn=lambda: (contextlib.nullcontext(), _drops_not_counted(moes)))
