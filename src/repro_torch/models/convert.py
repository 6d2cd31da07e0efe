"""Weights carried across from the JAX package: its LM parameter tree
(``repro.models.model.init_params`` or a checkpoint, as nested dicts of
NumPy arrays) becomes the state of the port's :class:`.model.LM`.

The reference stacks the layers of its scanned superblocks along a
leading ``n_blocks`` axis (``tree["blocks"]["l{i}"]``) and keeps the
remainder layers apart (``tree["rem{j}"]``); the port holds one flat list
of layers, so layer ``b * superblock + i`` is row ``b`` of block position
``i`` and layer ``n_blocks * superblock + j`` is ``rem{j}``.  Weights keep
the reference's ``(in, out)`` layout.  No module of that package is
imported.
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
    given as ``ml_dtypes`` arrays is read through its bits) of the
    reference's parameter tree for ``cfg``.  Load it with
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
    extra = sorted(set(tree) - {"embed", "blocks"}
                   - {f"rem{j}" for j in range(cfg.remainder_layers)})
    if extra:
        raise ValueError(f"parameters the dense LM does not have: {extra}")
    return state


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: no NumPy dtype torch reads
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy
