"""Blocks of the LM and their caches (the port of the JAX package's
``models/transformer.py``).

The reference scans ``cfg.superblock`` layers with stacked parameters and
runs ``cfg.remainder_layers`` more after the scan.  The port keeps the
same layers in one flat list, layer ``b * superblock + i`` being position
``i`` of block ``b`` and the remainder layers following, each of the kind
its position gives (``cfg.layer_kinds()``, ``cfg.ffn_kinds()``):

  mixers  attn / local / global (GQA attention, a ring for local layers),
          mamba (Jamba's SSD layers), rwkv (RWKV6's time mix);
  FFNs    dense (SwiGLU), moe (experts, Arctic's dense residual),
          rwkv_cm (RWKV6's channel mix).

A decoder of an encoder-decoder config adds a cross-attention sublayer
(``norm_x``, ``xattn``) after the mixer.  Each block owns its cache,
allocated at its final size before the prefill writes it (``cache_defs``)
and updated in place by every decode step; nothing is grown afterwards.
"""
from __future__ import annotations

import torch
from torch import nn

from .attention import Attention, cache_logical, write_prefix
from .layers import MLP, Init, rms_norm
from .mamba import CONV_K, Mamba
from .moe import MoE
from .rwkv import ChannelMix, TimeMix
from .sharding import DTensor, constrain

ATTENTION = ("attn", "local", "global")
MIXERS = ATTENTION + ("mamba", "rwkv")
FFNS = ("dense", "moe", "rwkv_cm")


def layer_plan(cfg) -> list[tuple[str, str]]:
    """``(mixer kind, FFN kind)`` of every decoder layer, in order."""
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    return [(kinds[li % cfg.superblock], ffns[li % cfg.superblock])
            for li in range(cfg.n_layers)]


def block_cache_defs(cfg, kind: str, ffn_kind: str, batch: int, cache_len: int,
                     cross_len: int = 0) -> dict:
    """``name -> (shape, float32 or not, logical axes)`` of one layer's
    cache: ``k``/``v`` ``(B, slots, Hk, hd)`` (a ring of ``min(window,
    cache_len)`` slots for a local layer); Mamba's ``conv`` ``(B, CONV_K -
    1, di)`` and ``state`` ``(B, H, d_state, hd)``; RWKV's ``state`` ``(B,
    H, hd, hd)`` and ``shift_tm``/``shift_cm`` ``(B, D)``; ``xk``/``xv``
    ``(B, cross_len, Hk, hd)`` for cross-attention.  Recurrent states are
    float32 (float64 in a float64 model), the rest in the activation
    dtype.  The logical axes are the reference's ``block_cache_defs``."""
    d, hd, hk = cfg.d_model, cfg.hd, cfg.n_kv_heads
    out = {}
    if kind in ATTENTION:
        if kind == "local" and cfg.local_window:
            out["k"] = out["v"] = ((batch, min(cfg.local_window, cache_len), hk, hd), False,
                                   ("fsdp", None, None, None))
        else:
            out["k"] = out["v"] = ((batch, cache_len, hk, hd), False,
                                   ("fsdp", "seq", None, None))
    elif kind == "mamba":
        di = cfg.mamba_expand * d
        out["conv"] = ((batch, CONV_K - 1, di), False, ("fsdp", None, "tp"))
        out["state"] = ((batch, di // cfg.mamba_head_dim, cfg.mamba_d_state,
                         cfg.mamba_head_dim), True, ("fsdp", "tp", None, None))
    else:
        h = d // cfg.rwkv_head_dim
        out["state"] = ((batch, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim), True,
                        ("fsdp", "tp", None, None))
        out["shift_tm"] = ((batch, d), False, ("fsdp", None))
    if ffn_kind == "rwkv_cm":
        out["shift_cm"] = ((batch, d), False, ("fsdp", None))
    if cross_len:
        out["xk"] = out["xv"] = ((batch, cross_len, hk, hd), False,
                                 ("fsdp", None, None, None))
    return out


class Block(nn.Module):
    """One layer: a pre-norm mixer, a pre-norm cross-attention when
    ``cross``, and a pre-norm FFN, each residual."""

    def __init__(self, cfg, kind: str, ffn_kind: str, init: Init, *, cross: bool = False,
                 causal: bool = True):
        super().__init__()
        if kind not in MIXERS or ffn_kind not in FFNS:
            raise ValueError(f"unknown layer kind {kind!r} / {ffn_kind!r}")
        self.cfg = cfg
        self.kind = kind
        self.ffn_kind = ffn_kind
        self.causal = causal
        self.window = cfg.local_window if kind == "local" else 0
        self.norm1 = init.ones(cfg.d_model)
        if kind in ATTENTION:
            self.mixer = Attention(cfg, init)
        elif kind == "mamba":
            self.mixer = Mamba(cfg, init)
        else:
            self.mixer = TimeMix(cfg, init)
        if cross:
            self.norm_x = init.ones(cfg.d_model)
            self.xattn = Attention(cfg, init)
        self.norm2 = init.ones(cfg.d_model)
        if ffn_kind == "dense":
            self.ffn = MLP(cfg.d_model, cfg.d_ff, init)
        elif ffn_kind == "moe":
            self.ffn = MoE(cfg, init)
        else:
            self.ffn = ChannelMix(cfg, init)

    def cache_defs(self, batch: int, cache_len: int, cross_len: int = 0) -> dict:
        """``name -> (shape, float32 or not)`` of this layer's cache
        (:func:`block_cache_defs`)."""
        return {name: (shape, f32) for name, (shape, f32, _) in
                block_cache_defs(self.cfg, self.kind, self.ffn_kind, batch, cache_len,
                                 cross_len).items()}

    def forward(self, x, cache=None, enc_out=None):
        """Train/prefill over ``(B, S, D)``.  With ``cache`` (this layer's
        dict from ``LM.new_cache``) the prefill writes it: attention keys
        and values at positions ``0..S-1`` (the newest ``min(S, slots)`` at
        slot ``pos % slots`` in a ring), the recurrent states and shifts at
        the last position, the cross-attention keys and values of
        ``enc_out`` (the encoder's output, given to every decoder layer)."""
        cfg = self.cfg
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind in ATTENTION:
            out, k, v = self.mixer(h, window=self.window, causal=self.causal)
            if cache is not None and isinstance(cache["k"], DTensor):
                logical = cache_logical(self.window)
                if self.window:
                    # the newest min(S, slots) positions, rolled so that
                    # position p lands in slot p % slots
                    first = max(k.shape[1] - cache["k"].shape[1], 0)
                    roll = first % cache["k"].shape[1]
                    k, v = k[:, first:].roll(roll, dims=1), v[:, first:].roll(roll, dims=1)
                write_prefix(cache["k"], logical, k)
                write_prefix(cache["v"], logical, v)
            elif cache is not None:
                s, slots = k.shape[1], cache["k"].shape[1]
                if self.window:
                    pos = torch.arange(max(s - slots, 0), s, device=k.device)
                    cache["k"][:, pos % slots] = k[:, pos]
                    cache["v"][:, pos % slots] = v[:, pos]
                else:
                    cache["k"][:, :s] = k
                    cache["v"][:, :s] = v
        elif self.kind == "mamba":
            out, conv, state = self.mixer(h)
            if cache is not None:
                cache["conv"].copy_(conv)
                cache["state"].copy_(state)
        else:
            out, prev, state = self.mixer(h)
            if cache is not None:
                cache["shift_tm"].copy_(prev)
                cache["state"].copy_(state)
        x = x + out
        if enc_out is not None:
            xk, xv = self.xattn.encode_kv(enc_out)
            if cache is not None:
                cache["xk"].copy_(xk)
                cache["xv"].copy_(xv)
            x = x + self.xattn.cross(rms_norm(x, self.norm_x, cfg.norm_eps), xk, xv)
        h2 = rms_norm(x, self.norm2, cfg.norm_eps)
        if self.ffn_kind == "rwkv_cm":
            f, prev_cm = self.ffn(h2)
            if cache is not None:
                cache["shift_cm"].copy_(prev_cm)
        else:
            f = self.ffn(h2)
        return constrain(x + f, None, ("fsdp", None, None))

    def decode(self, x, cache, pos):
        """One token ``(B, 1, D)`` at ``pos`` ``(B,)``; the cache is updated
        in place."""
        cfg = self.cfg
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind in ATTENTION:
            out = self.mixer.decode(h, cache["k"], cache["v"], pos, window=self.window)
        elif self.kind == "mamba":
            out, conv, state = self.mixer.decode(h[:, 0], cache["conv"], cache["state"])
            cache["conv"].copy_(conv)
            cache["state"].copy_(state)
            out = out[:, None]
        else:
            out, prev, state = self.mixer.decode(h[:, 0], cache["shift_tm"], cache["state"])
            cache["shift_tm"].copy_(prev)
            cache["state"].copy_(state)
            out = out[:, None]
        x = x + out
        if "xk" in cache:
            x = x + self.xattn.cross(rms_norm(x, self.norm_x, cfg.norm_eps), cache["xk"],
                                     cache["xv"])
        h2 = rms_norm(x, self.norm2, cfg.norm_eps)
        if self.ffn_kind == "rwkv_cm":
            f, prev_cm = self.ffn.decode(h2[:, 0], cache["shift_cm"])
            cache["shift_cm"].copy_(prev_cm)
            f = f[:, None]
        else:
            f = self.ffn(h2)
        return constrain(x + f, None, ("fsdp", None, None))
