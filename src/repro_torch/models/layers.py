"""Basic layers of the LM: RMS norm, rotary embedding, the SwiGLU
MLP, the token embedding and the output logits (the port of the JAX
package's ``models/layers.py``).

Weights keep the JAX package's layout, ``(in, out)``, and every layer
computes ``x @ w`` as it does, so a parameter tree carried across
(``models/convert.py``) needs no transpose.  Dtypes follow the
reference's promotions: norms and rotary angles run in float32 and cast
back to the activation dtype (a float64 model runs them in float64:
:func:`upcast`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .sharding import (DTensor, Partial, Replicate, Shard, axes_for_mesh, placements_for,
                       proj, shard_map_compat)

# padded vocab rows read this logit (the reference's mask value)
PAD_LOGIT = -1e30


def upcast(x):
    """``x`` in float32, the dtype of the reference's internals, or as it
    is if it is wider (a float64 model, a witness for float32 checks)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x, w, eps: float = 1e-6):
    var = upcast(x).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x, positions, theta: float = 1e4):
    """Rotary embedding over the last dim of ``(..., seq, heads, hd)``;
    ``positions`` is ``(..., seq)``.  Angles in float32 (float64 for a
    float64 ``x``), the result cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    wide = torch.promote_types(x.dtype, torch.float32)
    freqs = theta ** (-torch.arange(0, half, dtype=wide, device=x.device) / half)
    ang = positions[..., :, None].to(wide) * freqs         # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x, w1, w3, w2):
    """Gated MLP: ``(silu(x w1) * (x w3)) w2``, each product placed as on a
    mesh (``sharding.proj``)."""
    return proj(F.silu(proj(x, w1)) * proj(x, w3), w2)


class Init:
    """Draws every parameter of a model from one seeded generator on one
    device, in the order the model asks for them: normal draws scaled by
    ``fan_in ** -0.5`` (or ``scale``), drawn in float32 whatever the dtype
    (one seed gives the same weights, rounded, in every dtype), ones or
    zeros; ``empty=True`` allocates
    without drawing (for weights that are loaded next)."""

    def __init__(self, generator: torch.Generator | None, device, dtype, empty=False):
        self.generator = generator
        self.device = device
        self.dtype = dtype
        self.empty = empty

    def normal(self, *shape, scale: float | None = None) -> nn.Parameter:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if not self.empty:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            t.normal_(generator=self.generator).mul_(fan_in ** -0.5 if scale is None
                                                     else scale)
        return nn.Parameter(t.to(self.dtype), requires_grad=False)

    def ones(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, dtype=self.dtype, device=self.device),
                            requires_grad=False)

    def zeros(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=self.dtype, device=self.device),
                            requires_grad=False)


class MLP(nn.Module):
    def __init__(self, d: int, f: int, init: Init):
        super().__init__()
        self.w1 = init.normal(d, f)
        self.w3 = init.normal(d, f)
        self.w2 = init.normal(f, d)

    def forward(self, x):
        return swiglu(x, self.w1, self.w3, self.w2)


class Embedding(nn.Module):
    """Token embedding (``tok``, ``(padded_vocab, d)``), the final norm and
    the output projection (``out``, ``(d, padded_vocab)``, or ``tok``
    transposed when the embeddings are tied)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        # d^-0.5 keeps tied-embedding logits at unit scale
        self.tok = init.normal(cfg.padded_vocab, cfg.d_model, scale=cfg.d_model ** -0.5)
        if not cfg.tied_embeddings:
            self.out = init.normal(cfg.d_model, cfg.padded_vocab)
        self.final_norm = init.ones(cfg.d_model)

    def embed(self, tokens):
        if not isinstance(self.tok, DTensor):
            return self.tok[tokens]
        return vocab_parallel_embed(self.tok, tokens)

    def logits(self, x):
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        lg = proj(x, self.tok.T if self.cfg.tied_embeddings else self.out)
        return mask_padded_vocab(self.cfg, lg)


def vocab_parallel_embed(tok, tokens):
    """The rows of a DTensor table ``tok`` ``(V, D)`` for ``tokens`` ``(B,
    S)``, each rank looking up the tokens of its batch rows in its slice
    of the vocab (Megatron's parallel embedding, under ``local_map``:
    DTensor's sharding rule for an indexed read, and for its gradient's
    indexed write, differs between torch versions).  Rows of another
    rank's slice are zero here; the result is partial over 'model' until
    the caller reduces it.  Where the vocab is not split the lookup is the
    plain one."""
    mesh = tok.device_mesh
    axes = axes_for_mesh(mesh)
    model = mesh.mesh_dim_names.index("model")
    pt = placements_for(mesh, axes, ("tp", None), tok.shape)
    pi = placements_for(mesh, axes, ("fsdp", None), tokens.shape)
    split = isinstance(pt[model], Shard) and mesh.size(model) > 1
    out = [p if m != model else (Partial() if split else Replicate())
           for m, p in enumerate(pi)]
    grad = [p if m == model else (Partial() if isinstance(pi[m], Shard) else Replicate())
            for m, p in enumerate(pt)]

    def body(t, ids):
        if not split:
            return t[ids]
        first = mesh.get_coordinate()[model] * t.shape[0]
        rel = ids.long() - first
        hit = (rel >= 0) & (rel < t.shape[0])
        rows = t[rel.clamp(0, t.shape[0] - 1)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=t.dtype))

    return shard_map_compat(body, mesh, (pt, pi), out, (grad, pi))(tok, tokens)


def mask_padded_vocab(cfg, lg):
    if cfg.padded_vocab == cfg.vocab:
        return lg
    bad = torch.arange(cfg.padded_vocab, device=lg.device) >= cfg.vocab
    return lg.masked_fill(bad, PAD_LOGIT)
