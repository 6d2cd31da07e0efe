"""Weights carried across from the JAX package: its LM parameter tree
(``repro.models.model.init_params`` or a checkpoint, as nested dicts of
NumPy arrays) becomes the state of the port's :class:`.model.LM`.

The reference stacks the layers of its scanned superblocks along a
leading ``n_blocks`` axis (``tree["blocks"]["l{i}"]``) and keeps the
remainder layers apart (``tree["rem{j}"]``); the port holds one flat list
of layers, so layer ``b * superblock + i`` is row ``b`` of block position
``i`` and layer ``n_blocks * superblock + j`` is ``rem{j}``.  The
encoder's blocks are stacked along ``encoder_layers`` rows
(``tree["encoder"]``, row ``j`` the port's ``encoder.{j}``), and the VLM's
``patch_proj`` is one matrix.  Weights keep the reference's ``(in, out)``
layout, experts ``(E, in, out)``.  No module of that package is imported.

``arrays_from_params`` is the inverse: the port's state in the
reference's tree, its leaves in the reference's order (``jax.tree.leaves``
sorts dict keys at every level).  Checkpoints, the optimizers (which
update each reference leaf as one tensor, ``reference_leaves``) and the
gradient tests all use this one mapping.

``reference_logical`` gives a leaf's logical sharding axes, the
reference's ``Param.logical`` of ``layers.py``, ``attention.py``,
``mamba.py``, ``rwkv.py``, ``moe.py``, ``transformer.py`` and
``model.py`` gathered in one table (``LOGICAL``); a stacked leaf's axes
begin with None, as ``transformer.stack_defs`` prepends it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flat(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def params_from_arrays(cfg, tree: Mapping) -> dict:
    """The ``LM`` state dict (CPU tensors, the arrays' dtypes; bfloat16
    given as ``ml_dtypes`` arrays is read through its bits; leaves given
    as tensors stay where they are) of the reference's parameter tree for
    ``cfg``.  Load it with
    ``lm.load_state_dict(params_from_arrays(cfg, tree))``; it raises on a
    missing or an unexpected weight."""
    sb, n_blocks = cfg.superblock, cfg.n_blocks
    state = {}
    for name, value in _flat(tree["embed"], "embed."):
        state[name] = _tensor(value)
    for i in range(sb):
        for name, value in _flat(tree["blocks"][f"l{i}"]):
            if value.shape[0] != n_blocks:
                raise ValueError(f"blocks.l{i}.{name}: {value.shape[0]} rows, "
                                 f"expected n_blocks = {n_blocks}")
            for b in range(n_blocks):
                state[f"layers.{b * sb + i}.{name}"] = _tensor(value[b])
    for j in range(cfg.remainder_layers):
        for name, value in _flat(tree[f"rem{j}"]):
            state[f"layers.{n_blocks * sb + j}.{name}"] = _tensor(value)
    known = {"embed", "blocks"} | {f"rem{j}" for j in range(cfg.remainder_layers)}
    if cfg.encoder_layers:
        known.add("encoder")
        for name, value in _flat(tree["encoder"]):
            if value.shape[0] != cfg.encoder_layers:
                raise ValueError(f"encoder.{name}: {value.shape[0]} rows, expected "
                                 f"encoder_layers = {cfg.encoder_layers}")
            for j in range(cfg.encoder_layers):
                state[f"encoder.{j}.{name}"] = _tensor(value[j])
    if cfg.frontend == "patch_stub":
        known.add("patch_proj")
        state["patch_proj"] = _tensor(tree["patch_proj"])
    extra = sorted(set(tree) - known)
    if extra:
        raise ValueError(f"parameters {cfg.name} does not have: {extra}")
    return state


def reference_leaves(cfg, names) -> list[tuple[tuple[str, ...], list[str], bool]]:
    """The reference's parameter leaves for the port's parameter ``names``
    (``LM.state_dict()`` keys), in the reference's leaf order: ``(path,
    rows, stacked)``, ``path`` the leaf's keys in the reference's tree,
    ``rows`` the port's names that make it (row ``b`` of a stacked leaf is
    ``rows[b]``), ``stacked`` whether the leaf has a leading ``n_blocks``
    (``blocks``) or ``encoder_layers`` (``encoder``) axis."""
    sb, n_blocks = cfg.superblock, cfg.n_blocks
    leaves: dict[tuple[str, ...], list] = {}
    for name in names:
        head, _, rest = name.partition(".")
        if head == "layers":
            li, _, rest = rest.partition(".")
            b, i = divmod(int(li), sb)
            if b < n_blocks:
                path, row = ("blocks", f"l{i}", *rest.split(".")), b
            else:
                path, row = (f"rem{int(li) - n_blocks * sb}", *rest.split(".")), None
        elif head == "encoder":
            j, _, rest = rest.partition(".")
            path, row = ("encoder", *rest.split(".")), int(j)
        else:
            path, row = tuple(name.split(".")), None
        leaves.setdefault(path, []).append((row, name))
    out = []
    for path in sorted(leaves):
        rows = sorted(leaves[path], key=lambda r: -1 if r[0] is None else r[0])
        out.append((path, [name for _, name in rows], rows[0][0] is not None))
    return out


_MLP = {"w1": ("fsdp", "tp"), "w3": ("fsdp", "tp"), "w2": ("tp", "fsdp")}
_ATTN = {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
         "wo": ("tp", "fsdp"), "q_norm": (None,), "k_norm": (None,)}
# the reference's Param.logical of every leaf, by where it sits in a layer
LOGICAL = {
    "embed": {"tok": ("tp", "fsdp"), "out": ("fsdp", "tp"), "final_norm": (None,)},
    "patch_proj": ("fsdp", None),
    "block": {"norm1": (None,), "norm2": (None,), "norm_x": (None,)},
    "xattn": _ATTN,
    "mixer": {
        "attn": _ATTN,
        "mamba": {"in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"),
                  "wB": ("fsdp", "tp"), "wC": ("fsdp", "tp"), "w_dt": ("fsdp", "tp"),
                  "dt_bias": (None,), "D": (None,), "out_proj": ("tp", "fsdp")},
        "rwkv": {"mix": (None, None), "wr": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
                 "wv": ("fsdp", "tp"), "wg": ("fsdp", "tp"), "wo": ("tp", "fsdp"),
                 "w0": (None,), "w_lora_a": ("fsdp", None), "w_lora_b": (None, "fsdp"),
                 "u": (None, None), "ln_out": (None,)},
    },
    "ffn": {
        "dense": _MLP,
        "moe": {"router": (None, None), "w1": ("tp", "fsdp", None),
                "w3": ("tp", "fsdp", None), "w2": ("tp", None, "fsdp")},
        "rwkv_cm": {"mix": (None, None), "wk": ("fsdp", "tp"), "wv": ("tp", "fsdp"),
                    "wr": ("fsdp", None)},
    },
}


def _layer_kinds(cfg, path):
    """``(mixer kind, FFN kind, the path inside the layer)`` of a layer
    leaf's path."""
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    if path[0] == "blocks":
        i = int(path[1][1:])
        return kinds[i], ffns[i], path[2:]
    if path[0] == "encoder":
        return "attn", "dense", path[1:]
    li = cfg.n_blocks * cfg.superblock + int(path[0][3:])
    return kinds[li % cfg.superblock], ffns[li % cfg.superblock], path[1:]


def reference_logical(cfg, path) -> tuple:
    """The logical axes of the reference's leaf at ``path`` (a
    :func:`reference_leaves` path), the stack axis included (None) for a
    ``blocks`` or ``encoder`` leaf."""
    if path[0] == "embed":
        return LOGICAL["embed"][path[1]]
    if path[0] == "patch_proj":
        return LOGICAL["patch_proj"]
    kind, ffn, rest = _layer_kinds(cfg, path)
    head = (None,) if path[0] in ("blocks", "encoder") else ()
    if len(rest) == 1:
        return head + LOGICAL["block"][rest[0]]
    if rest[0] == "xattn":
        return head + LOGICAL["xattn"][rest[1]]
    if rest[0] == "mixer":
        mixer = "attn" if kind in ("attn", "local", "global") else kind
        return head + LOGICAL["mixer"][mixer][rest[1]]
    if rest[1] == "dense":                       # arctic's dense residual
        return head + _MLP[rest[2]]
    return head + LOGICAL["ffn"][ffn][rest[1]]


def arrays_from_params(cfg, state: Mapping) -> dict:
    """The reference's parameter tree (nested dicts of tensors, keys sorted
    at every level, so that iteration gives the reference's leaf order) of
    the port's ``state`` (``lm.state_dict()`` or any mapping of those names
    to tensors): the inverse of :func:`params_from_arrays`.  Stacked leaves
    are new tensors on the rows' device; the others are ``state``'s own."""
    tree: dict = {}
    for path, rows, stacked in reference_leaves(cfg, state):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (torch.stack([state[r] for r in rows]) if stacked
                          else state[rows[0]])
    return tree


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: no NumPy dtype torch reads
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy
