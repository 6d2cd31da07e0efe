"""Blocks of the dense LM and their caches (the port of the JAX package's
``models/transformer.py`` for the dense families).

The reference scans ``cfg.superblock`` layers with stacked parameters and
runs ``cfg.remainder_layers`` more after the scan.  The port keeps the
same layers in one flat list, layer ``b * superblock + i`` being position
``i`` of block ``b`` and the remainder layers following, each of the kind
its position gives (``cfg.layer_kinds()``, ``cfg.ffn_kinds()``).

This slice ports the ``attn``/``local``/``global`` mixers with a dense
SwiGLU FFN (qwen3, internlm2, gemma3).  Any other mixer or FFN kind
(``mamba``, ``rwkv``, ``moe``, ``rwkv_cm``), an encoder (cross attention)
or a stub front end raises ``NotImplementedError`` when the model is
built (ROADMAP A.8.1b).
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import Attention
from .layers import MLP, Init, rms_norm

MIXERS = ("attn", "local", "global")
FFNS = ("dense",)


def layer_plan(cfg) -> list[tuple[str, str]]:
    """``(mixer kind, FFN kind)`` of every layer, in order; raises for a
    kind this slice does not port."""
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    plan = [(kinds[li % cfg.superblock], ffns[li % cfg.superblock])
            for li in range(cfg.n_layers)]
    bad = sorted({k for k, _ in plan if k not in MIXERS} | {f for _, f in plan if f not in FFNS})
    if bad or cfg.encoder_layers or cfg.frontend != "none":
        what = bad + (["encoder"] if cfg.encoder_layers else []) + (
            [f"frontend {cfg.frontend}"] if cfg.frontend != "none" else [])
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what)} not ported yet (ROADMAP A.8.1b); the port "
            f"serves the dense families (attn/local/global mixers, dense FFN)")
    return plan


class Block(nn.Module):
    """One layer: pre-norm attention and pre-norm SwiGLU, both residual."""

    def __init__(self, cfg, kind: str, init: Init):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.window = cfg.local_window if kind == "local" else 0
        self.norm1 = init.ones(cfg.d_model)
        self.mixer = Attention(cfg, init)
        self.norm2 = init.ones(cfg.d_model)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, init)

    def cache_len(self, cache_len: int) -> int:
        """Slots of this layer's cache: a ring of the window for a local
        layer, the whole context otherwise."""
        return min(self.window, cache_len) if self.window else cache_len

    def forward(self, x, cache=None):
        """Train/prefill over ``(B, S, D)``.  With ``cache`` (``{"k", "v"}``
        of ``(B, cache_len(...), Hk, hd)``), the layer's keys and values
        are written into it: positions ``0..S-1`` in a full cache, the
        newest ``min(S, slots)`` at slot ``pos % slots`` in a ring."""
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        out, k, v = self.mixer(h, window=self.window)
        if cache is not None:
            s, slots = k.shape[1], cache["k"].shape[1]
            if self.window:
                pos = torch.arange(max(s - slots, 0), s, device=k.device)
                cache["k"][:, pos % slots] = k[:, pos]
                cache["v"][:, pos % slots] = v[:, pos]
            else:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
        x = x + out
        return x + self.ffn(rms_norm(x, self.norm2, self.cfg.norm_eps))

    def decode(self, x, cache, pos):
        """One token ``(B, 1, D)`` at ``pos`` ``(B,)``; the cache is updated
        in place."""
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        x = x + self.mixer.decode(h, cache["k"], cache["v"], pos, window=self.window)
        return x + self.ffn(rms_norm(x, self.norm2, self.cfg.norm_eps))
