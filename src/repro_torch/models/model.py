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

On a device mesh (``launch/mesh.py``), ``shard_lm`` turns the
parameters into DTensors placed by their logical axes (``param_pspecs``,
the reference's ``Param.logical`` of each leaf, ``models/sharding.py``);
run the model inside ``use_mesh(mesh)`` on DTensor inputs (``input_specs``
builds them for a cell) and the forward redistributes its activations
where the reference constrains them.  ``abstract_params`` builds the
sharded model under ``FakeTensorMode`` for the dry run
(``launch/dryrun.py``): it allocates nothing, so arctic-480b fits.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.queries_torch import resolve_device
from .convert import reference_leaves, reference_logical
from .layers import PAD_LOGIT, Embedding, Init, mask_padded_vocab, rms_norm, upcast
from .moe import MoE
from .sharding import (DTensor, Partial, Replicate, Shard, ambient_mesh, axes_for_mesh,
                       constrain, empty_like_placed, gathered, placements_for, proj,
                       shard_map_compat)
from .transformer import Block, block_cache_defs, layer_plan

# patch positions of the VLM's stub front end in the reference's cells
VLM_PATCH_TOKENS = 256
ENCDEC_DECODER_FRACTION = 8     # an encoder-decoder cell's decoder: seq_len // 8
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
        x = constrain(x, None, ("fsdp", None, None))
        if cfg.frontend == "patch_stub":
            if patch_embeds is None:
                raise ValueError(f"{cfg.name} has a patch front end: pass patch_embeds=")
            pe = torch.as_tensor(patch_embeds, device=self.device).to(x.dtype)
            patches = proj(pe, self.patch_proj).to(x.dtype)
            x = constrain(torch.cat([patches, x], dim=1), None, ("fsdp", None, None))
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
        w = gathered(self.embed.tok.T if cfg.tied_embeddings else self.embed.out)
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
        if not isinstance(xc, DTensor):
            lg = mask_padded_vocab(self.cfg, upcast(xc @ w))
            gold = lg.gather(-1, tc[..., None])[..., 0]
            return torch.sum(torch.logsumexp(lg, dim=-1) - gold)
        # on a mesh the vocab stays split over 'model' (Megatron's parallel
        # cross entropy): DTensor has no sharding rule for gather, and
        # torch.logsumexp would gather every logit
        return _vocab_parallel_nll(self.cfg, xc.reshape(-1, xc.shape[-1]) @ w,
                                   tc.reshape(-1))

    def new_cache(self, batch: int, cache_len: int, cross_len: int = 0) -> list[dict]:
        """Zeroed caches at their final size for ``cache_len`` positions (and
        ``cross_len`` encoder positions): one dict per layer
        (``Block.cache_defs``); DTensors placed by the reference's cache
        axes when a mesh is active (:func:`make_cache_struct`)."""
        if ambient_mesh() is not None:
            cache = make_cache_struct(self.cfg, batch, cache_len, ambient_mesh(),
                                      cross_len, device=self.device, dtype=self.act_dtype)
            for layer in cache:
                for t in layer.values():
                    t.zero_()
            return cache
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


class _SumOver(torch.autograd.Function):
    """A sum over a mesh dim's ranks in the forward; the gradient passes as
    it is, for a result every rank then holds whole (Megatron's reduce
    from the model-parallel region)."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(t, "sum", (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _vocab_parallel_nll(cfg, lg, tc):
    """The summed negative log-likelihood of ``(T, V)`` logits (a DTensor,
    the vocab split over 'model') against ``(T,)`` targets, each rank on its
    tokens and vocab columns under ``local_map``: the padded vocab
    masked, the gold logit and jax.nn.logsumexp's max and exp-sum reduced
    over 'model'.  Returns the sum as a DTensor, partial over the data
    dims where the tokens are split."""
    from torch.distributed import _functional_collectives as funcol

    mesh = lg.device_mesh
    model = mesh.mesh_dim_names.index("model")
    axes = axes_for_mesh(mesh)
    pl = placements_for(mesh, axes, ("fsdp", "tp"), lg.shape)
    pt = placements_for(mesh, axes, ("fsdp",), tc.shape)
    split = isinstance(pl[model], Shard) and mesh.size(model) > 1
    out = [Partial() if isinstance(p, Shard) else Replicate() for p in pt]

    def body(lg, tc):
        lg = upcast(lg)
        if not split:        # the whole vocab here: the plain step's ops
            lg = mask_padded_vocab(cfg, lg)
            gold = lg.gather(-1, tc[:, None])[:, 0]
            return torch.sum(torch.logsumexp(lg, dim=-1) - gold)
        first = mesh.get_coordinate()[model] * lg.shape[-1]
        cols = torch.arange(first, first + lg.shape[-1], device=lg.device)
        if cfg.padded_vocab != cfg.vocab:
            lg = lg.masked_fill(cols >= cfg.vocab, PAD_LOGIT)
        top = lg.detach().amax(dim=-1, keepdim=True)
        gold = torch.where(cols == tc[:, None], lg, torch.zeros((), dtype=lg.dtype)).sum(-1)
        top = funcol.wait_tensor(funcol.all_reduce(top, "max", (mesh, model)))
        sumexp = _SumOver.apply(torch.exp(lg - top).sum(dim=-1), mesh, model)
        gold = _SumOver.apply(gold, mesh, model)
        return torch.sum(torch.log(sumexp) + top[:, 0] - gold)

    return shard_map_compat(body, mesh, (pl, pt), out, (pl, pt))(lg, tc)


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


# --------------------------------------------------------------------------
# the model on a device mesh
# --------------------------------------------------------------------------
def param_logical(cfg, names=None) -> dict:
    """``name -> logical axes`` of the port's parameters (``LM`` state
    names; every one unless ``names``): the reference leaf's
    ``Param.logical`` with the stack axis dropped."""
    if names is None:
        names = [n for n, _ in LM(cfg, device="meta", empty=True).named_parameters()]
    out = {}
    for path, rows, stacked in reference_leaves(cfg, names):
        logical = reference_logical(cfg, path)
        for name in rows:
            out[name] = logical[1:] if stacked else logical
    return out


def param_pspecs(cfg, axes, names=None) -> dict:
    """``name -> placements`` (one per mesh dim, ``axes.resolve``) of the
    port's parameters, before ``shape_safe_spec``."""
    return {name: axes.resolve(lg) for name, lg in param_logical(cfg, names).items()}


def shard_lm(lm: LM, mesh) -> LM:
    """Turn ``lm``'s parameters, in place, into DTensors on ``mesh`` placed
    by their logical axes (axes that do not divide a dim dropped,
    ``shape_safe_spec``): each rank keeps its shard of the full weights it
    holds.  Returns ``lm``."""
    from torch.distributed.tensor import distribute_tensor

    axes = axes_for_mesh(mesh)
    named = dict(lm.named_parameters())
    logical = param_logical(lm.cfg, list(named))
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        module = lm.get_submodule(owner) if owner else lm
        placements = placements_for(mesh, axes, logical[name], p.shape)
        setattr(module, leaf, nn.Parameter(distribute_tensor(p.data, mesh, placements),
                                           requires_grad=p.requires_grad))
    lm.mesh = mesh
    return lm


def abstract_params(cfg, mesh, dtype=None) -> LM:
    """The LM of ``cfg`` (in ``dtype``, the config's unless given) sharded
    on ``mesh``, built under the active ``FakeTensorMode``: every weight is
    a DTensor over a fake local shard (placed as ``shard_lm`` places it),
    nothing is allocated.  The counterpart of the reference's
    ``ShapeDtypeStruct`` tree."""
    from torch._guards import detect_fake_mode

    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if detect_fake_mode() is None:
        raise RuntimeError("abstract_params builds fake weights: call it under "
                           "FakeTensorMode")
    # the module on 'meta' (no storage), then each weight a fake local shard
    lm = LM(cfg, device="meta", empty=True)
    axes = axes_for_mesh(mesh)
    named = dict(lm.named_parameters())
    logical = param_logical(cfg, list(named))
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        placements = placements_for(mesh, axes, logical[name], p.shape)
        setattr(lm.get_submodule(owner) if owner else lm, leaf,
                nn.Parameter(empty_like_placed(p.shape, p.dtype, mesh, placements, "cpu"),
                             requires_grad=False))
    for m in lm.modules():
        if isinstance(m, MoE):
            m.dropped = torch.zeros((), dtype=torch.int64)
    lm.device = torch.device("cpu")
    lm.mesh = mesh
    return lm


def _placed(shape, dtype, logical, mesh, device):
    """A DTensor of ``shape`` placed by ``logical`` on ``mesh`` (local shard
    allocated, unfilled); a plain tensor without a mesh."""
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device=device)
    placements = placements_for(mesh, axes_for_mesh(mesh), logical, shape)
    return empty_like_placed(shape, dtype, mesh, placements, device)


def make_cache_struct(cfg, batch: int, cache_len: int, mesh=None, cross_len: int = 0,
                      *, device="cpu", dtype=None) -> list[dict]:
    """Caches of every layer (``LM.new_cache``'s layout) for ``cache_len``
    positions, unfilled, placed on ``mesh`` by the reference's cache axes
    (``transformer.block_cache_defs``); under ``FakeTensorMode`` they are
    the dry run's stand-ins."""
    act = dtype or _DTYPES[cfg.dtype]
    wide = torch.promote_types(act, torch.float32)
    return [{name: _placed(shape, wide if f32 else act, logical, mesh, device)
             for name, (shape, f32, logical) in
             block_cache_defs(cfg, kind, ffn, batch, cache_len, cross_len).items()}
            for kind, ffn in layer_plan(cfg)]


# logical axes of a batch's tensors (the reference's input_specs)
INPUT_LOGICAL = {"tokens": ("fsdp", None), "labels": ("fsdp", None), "token": ("fsdp", None),
                 "pos": ("fsdp",), "frames": ("fsdp", None, None),
                 "patch_embeds": ("fsdp", None, None)}


def shard_batch(batch: dict, mesh) -> dict:
    """A batch of full tensors (every rank's the same) as DTensors placed
    by ``INPUT_LOGICAL``: each rank keeps its rows."""
    from torch.distributed.tensor import distribute_tensor

    axes = axes_for_mesh(mesh)
    return {k: distribute_tensor(torch.as_tensor(v), mesh,
                                 placements_for(mesh, axes, INPUT_LOGICAL[k], v.shape))
            for k, v in batch.items()}


def input_specs(cfg, shape, mesh, *, device="cpu") -> dict:
    """A cell's inputs (``configs.base.SHAPES``), unfilled, placed on
    ``mesh``: int32 ``tokens`` (and ``labels`` for training) ``(B, S)``
    over the data axes; an encoder-decoder's ``frames`` ``(B, S, D)`` with
    ``S // 8`` decoder tokens; the VLM's ``VLM_PATCH_TOKENS``
    ``patch_embeds`` before ``S - 256`` tokens; a decode cell's ``token``
    ``(B, 1)``, ``pos`` ``(B,)`` and the ``cache`` of ``S`` positions."""
    b, s = shape.global_batch, shape.seq_len
    act = _DTYPES[cfg.dtype]

    def tok(bb, ss):
        return _placed((bb, ss), torch.int32, ("fsdp", None), mesh, device)

    def emb(bb, ss):
        return _placed((bb, ss, cfg.d_model), act, ("fsdp", None, None), mesh, device)

    if shape.kind in ("train", "prefill"):
        out = {}
        if cfg.encoder_layers:
            st = s // ENCDEC_DECODER_FRACTION
            out["frames"] = emb(b, s)
        elif cfg.frontend == "patch_stub":
            st = s - VLM_PATCH_TOKENS
            out["patch_embeds"] = emb(b, VLM_PATCH_TOKENS)
        else:
            st = s
        out["tokens"] = tok(b, st)
        if shape.kind == "train":
            out["labels"] = tok(b, st)
        return out
    cross = s // ENCDEC_DECODER_FRACTION if cfg.encoder_layers else 0
    return {"token": tok(b, 1),
            "pos": _placed((b,), torch.int32, ("fsdp",), mesh, device),
            "cache": make_cache_struct(cfg, b, s, mesh, cross, device=device)}
