"""Roofline analysis of the port's dry-run traces (the port of the JAX
package's ``roofline.py``), in H100 constants.

Three terms per (arch x shape x mesh), in seconds:

  compute_s    = FLOPs / (chips * 989e12 bf16 dense FLOP/s)
  memory_s     = HBM bytes / (chips * 3.35e12 B/s)
  collective_s = collective bytes / (chips * 450e9 B/s NVLink, each way)

The constants are the NVIDIA H100 SXM5 80 GB data sheet's, at 700 W
(``chip_smoke.py`` holds the same three: ``HBM_BYTES_PER_S``,
``F32_OPS_PER_S``, ``BF16_DENSE_PEAK``).

Where the reference reads XLA's compiled HLO text (``cost_analysis``,
``parse_collectives`` with its while-loop trip counts, ``op_census``), the
port reads a traced step: :class:`StepTrace` is a dispatch mode that sees
each rank's *local* ATen ops under DTensor (it defers a DTensor op to
DTensor's own dispatch and counts the local ops that come back), so that

  * FLOPs are per device, XLA's meaning, counted on the local tensors
    with ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention);
  * collectives are DTensor's functional collectives by kind, each call's
    bytes those of its result (as ``parse_collectives`` takes the result
    type);
  * the op census counts the reference's categories among the ATen ops;
  * memory is the live bytes of the local storages: the peak, and the
    arguments registered before the step (``temporary = peak - args``);
  * ``bytes_accessed`` counts, unfused, every input and output of each op
    that is not a view (XLA's counts its fused kernels' traffic).

The trace has no loop to multiply: every layer and microbatch it runs
is counted where it runs.  The HLO readers (``_shape_bytes`` and the
regexes) have no counterpart.

``analytic_flops``, ``analytic_hbm_bytes``, ``probe_extrapolate``, the
kernel byte models and ``kernel_roofline`` are the reference's own
formulas, copied.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .models.sharding import DTensor

# --- NVIDIA H100 SXM5 80 GB (data sheet, 700 W) -----------------------------
PEAK_FLOPS = 989e12          # bf16 dense, per GPU
PEAK_FLOPS_F32 = 67e12       # float32 outside the tensor cores, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s per GPU, each way (NVLink 4, 900 GB/s total)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "broadcast")

# DTensor's functional collectives (torch.ops._c10d_functional) by kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}

# the reference's op_census categories among ATen ops
CENSUS = {
    "copy": ("copy", "copy_", "_to_copy", "clone", "_copy_from"),
    "transpose": ("transpose", "t", "permute", "transpose_", "t_"),
    "reshape": ("view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
                "squeeze", "unsqueeze", "flatten", "unflatten", "split", "chunk"),
    "gather": ("index", "gather", "index_select", "embedding", "take_along_dim"),
    "scatter": ("index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
                "scatter_add", "scatter_add_", "index_add", "index_add_",
                "embedding_dense_backward"),
    "dynamic-slice": ("slice", "select", "narrow"),
    "dynamic-update-slice": ("slice_scatter", "select_scatter"),
}
_CENSUS_OF = {name: cat for cat, names in CENSUS.items() for name in names}

_SKIP = {"size", "sym_size", "stride", "sym_stride", "numel", "sym_numel", "dim",
         "storage_offset", "sym_storage_offset", "is_contiguous", "sym_is_contiguous",
         "is_strides_like_format", "is_non_overlapping_and_dense", "layout", "device"}


class _Propagating:
    """Marks the ops that DTensor runs to derive an output's global shape
    (``ShardingPropagator._propagate_tensor_meta*``, private, checked on
    torch 2.11 and 2.13): they are not the rank's work and are not
    counted."""

    depth = 0
    users = 0
    _patched: list = []

    @classmethod
    def install(cls):
        cls.users += 1
        if cls.users > 1:
            return
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        names = [n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)]
        if not names:
            raise RuntimeError("this torch's ShardingPropagator has no "
                               "_propagate_tensor_meta: StepTrace needs a port")
        for name in names:
            orig = getattr(ShardingPropagator, name)

            def wrapped(self, *a, _orig=orig, **k):
                cls.depth += 1
                try:
                    return _orig(self, *a, **k)
                finally:
                    cls.depth -= 1

            for attr in ("cache_info", "cache_clear"):
                if hasattr(orig, attr):
                    setattr(wrapped, attr, getattr(orig, attr))
            cls._patched.append((ShardingPropagator, name, orig))
            setattr(ShardingPropagator, name, wrapped)

    @classmethod
    def remove(cls):
        cls.users -= 1
        if cls.users:
            return
        while cls._patched:
            owner, name, orig = cls._patched.pop()
            setattr(owner, name, orig)


class StepTrace(TorchDispatchMode):
    """Counts one rank's work in the block it is entered for: ``flops``
    (per device), ``bytes_accessed`` (unfused), ``collectives`` (``{"by_kind", "counts",
    "total_bytes"}``), ``census`` (the reference's ``op_census`` keys over
    ATen ops, plus ``ops``, every counted op) and the live bytes of local
    storages (``peak_bytes``; ``arg_bytes`` after :meth:`add_arguments`).

    Enter it inside a ``FakeTensorMode`` to trace without allocating, or
    alone to count a real run.  A DTensor op is left to DTensor, whose
    local ops then come through here; the ops DTensor runs to derive
    global shapes are skipped."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.coll_bytes: dict = defaultdict(float)
        self.coll_counts: dict = defaultdict(int)
        self.census: dict = defaultdict(int)
        self.bytes_accessed = 0
        self.live = 0
        self.peak_bytes = 0
        self.arg_bytes = 0
        self._seen: dict = {}

    # --- memory -----------------------------------------------------------
    def _track(self, t) -> int:
        """Count ``t``'s storage if it is new; returns the bytes added."""
        if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return 0
        n = st.nbytes()
        self._seen[key] = (weakref.ref(st, lambda _r, k=key, n=n: self._release(k, n)), n)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        return n

    def _release(self, key, n):
        if self._seen.pop(key, None) is not None:
            self.live -= n

    def add_arguments(self, tensors) -> int:
        """Register the step's arguments (DTensors by their local shards):
        they are live from the start.  Returns the bytes added."""
        added = 0
        for t in tensors:
            added += self._track(t.to_local() if isinstance(t, DTensor) else t)
        self.arg_bytes += added
        return added

    # --- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        name = func._overloadpacket.__name__
        if _Propagating.depth or name in _SKIP:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self._flop_registry and func is not torch.ops.prim.device.default:
            # as FlopCounterMode does: an op with no formula may decompose
            # into ops that have one
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.census["ops"] += 1
        if not any(r.alias_info is not None for r in func._schema.returns):
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in (*flat, *tree_flatten(out)[0])
                                       if isinstance(t, torch.Tensor))
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs, out_val=out)
        ns = getattr(func, "namespace", "")
        if ns == "_c10d_functional" and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
            self.coll_bytes[kind] += sum(o.numel() * o.element_size() for o in outs)
            self.coll_counts[kind] += 1
            self.census[kind] += 1
        elif name in _CENSUS_OF:
            self.census[_CENSUS_OF[name]] += 1
        for o in tree_flatten(out)[0]:
            self._track(o)
        return out

    def __enter__(self):
        _Propagating.install()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _Propagating.remove()

    # --- results ----------------------------------------------------------
    def collectives(self) -> dict:
        """``{"by_kind": {kind: bytes}, "counts": {kind: n}, "total_bytes"}``
        (``parse_collectives``'s layout)."""
        return {"by_kind": dict(self.coll_bytes), "counts": dict(self.coll_counts),
                "total_bytes": float(sum(self.coll_bytes.values()))}

    def op_census(self) -> dict:
        out = {k: 0 for k in (*CENSUS, *COLLECTIVES, "ops")}
        out.update(self.census)
        return out


# --------------------------------------------------------------------------
# probe extrapolation + analytic model (the reference's formulas)
# --------------------------------------------------------------------------
def probe_extrapolate(probe: dict, n_blocks: int) -> dict:
    """Per-block costs from unrolled 1-/2-block probes -> full-depth totals.

    total(n) = base + per_block * n, from total(1) and total(2)."""
    one, two = probe["blocks1"], probe["blocks2"]
    out = {}
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        per = two[key] - one[key]
        base = one[key] - per
        out[key] = base + per * n_blocks
        out[f"{key}_per_block"] = per
    return out


def analytic_flops(cfg, shape, n_micro: int = 1) -> dict:
    """Closed-form FLOPs for one step of the cell (global, all chips).

    Forward matmul flops 2*N_active_nonembed*T + attention; train multiplies
    by 4 (bwd 2x + full-remat recompute 1x); microbatching does not change
    totals."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    d, hd = cfg.d_model, cfg.hd
    kinds = cfg.layer_kinds()
    ffns = cfg.ffn_kinds()
    sb = cfg.superblock

    def layer_flops(i: int, T: int, S_ctx: int) -> float:
        k, f = kinds[i % sb], ffns[i % sb]
        fl = 0.0
        if k in ("attn", "local", "global"):
            proj = 2 * T * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
                + 2 * T * cfg.n_heads * hd * d
            # EXECUTED flops: the q-chunked einsum computes every (q, k)
            # score and masks afterwards, so causal masking does NOT halve
            # the work, and naive local attention pays the full context;
            # the sliced-KV path (local_slice_opt) pays window + chunk.
            if k == "local" and cfg.local_window and kind != "decode":
                if cfg.local_slice_opt:
                    cq = min(cfg.chunk_q, T // B)
                    ctx = min(cfg.local_window + cq, S_ctx)
                else:
                    ctx = S_ctx
            elif k == "local" and cfg.local_window and kind == "decode":
                ctx = min(cfg.local_window, S_ctx)
            else:
                ctx = S_ctx
            att = 2 * 2 * B * cfg.n_heads * (T // B) * ctx * hd
            fl += proj + att
        elif k == "mamba":
            di = cfg.mamba_expand * d
            N = cfg.mamba_d_state
            fl += 2 * T * d * (2 * di + 2 * (di // cfg.mamba_head_dim) * N
                               + di // cfg.mamba_head_dim) \
                + 2 * T * di * d
            H = di // cfg.mamba_head_dim
            c = cfg.la_chunk
            fl += 2 * T * H * (2 * c * N + 2 * N * cfg.mamba_head_dim
                               + c * cfg.mamba_head_dim)
        elif k == "rwkv":
            fl += 2 * T * d * d * 5  # r,k,v,g,o
            H = d // cfg.rwkv_head_dim
            c = cfg.la_chunk
            dk = cfg.rwkv_head_dim
            fl += 2 * T * H * (2 * c * dk + 2 * dk * dk + c * dk)
        if f == "dense":
            fl += 2 * 3 * T * d * cfg.d_ff
        elif f == "moe":
            fl += 2 * T * d * cfg.n_experts  # router
            fl += 2 * 3 * T * cfg.moe_top_k * cfg.capacity_factor * d * \
                (cfg.moe_dff or cfg.d_ff)
            if cfg.dense_residual:
                fl += 2 * 3 * T * d * cfg.d_ff
        elif f == "rwkv_cm":
            fl += 2 * T * (2 * d * cfg.d_ff + d * d)
        return fl

    if kind == "decode":
        T = B  # one token per sequence
        S_ctx = S
    else:
        T = B * S
        S_ctx = S

    fwd = 0.0
    n_full = cfg.n_layers
    for i in range(n_full):
        fwd += layer_flops(i, T, S_ctx)
    if cfg.encoder_layers and kind != "decode":
        # encoder over frames + decoder cross-attention
        Te = B * S
        for i in range(cfg.encoder_layers):
            fwd += (2 * Te * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                    + 2 * Te * cfg.n_heads * hd * d
                    + 2 * 2 * B * cfg.n_heads * S * S * hd * 0.5
                    + 2 * 3 * Te * d * cfg.d_ff)
        Td = T // 8 if kind != "decode" else T
        fwd += n_full * (2 * Td * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                         + 2 * Td * cfg.n_heads * hd * d
                         + 2 * 2 * B * cfg.n_heads * (Td // B) * S * hd)
    # logits / loss head
    T_head = (B * (S // 8) if cfg.encoder_layers else T) if kind == "train" \
        else B
    fwd += 2 * T_head * d * cfg.vocab

    mult = 4.0 if kind == "train" else 1.0  # bwd 2x + remat recompute 1x
    # useful model flops: 6*N_active*D for training, 2*N_active*D forward
    per_tok = 6 if kind == "train" else 2
    model_flops = per_tok * cfg.params_count()[1] * (
        T_head if kind == "train" else T
    )
    return {
        "fwd_flops": fwd,
        "total_flops": fwd * mult,
        "model_flops_6nd": model_flops,
    }


def analytic_hbm_bytes(cfg, shape, n_micro: int = 1) -> float:
    """Estimated HBM traffic per step (global, all chips), the fallback
    when probe extrapolation is degenerate.

    train:   params read 3x (fwd + remat-fwd + bwd) + grad write/read (4B)
             + optimizer state r/w + activation traffic
    prefill: params 1x + KV cache write + activations
    decode:  params 1x + full cache read + tiny activations
    """
    total, active = cfg.params_count()
    B, S = shape.global_batch, shape.seq_len
    pbytes = total * 2  # bf16
    act_unit = cfg.d_model * 2
    if shape.kind == "train":
        tokens = B * S
        act = 8 * tokens * act_unit * cfg.n_layers
        grads = total * 4 * 2
        opt = total * 2 * 2
        return 3 * pbytes + grads + opt + act
    if shape.kind == "prefill":
        tokens = B * S
        cache = (2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2
                 if cfg.n_heads else 0)
        act = 6 * tokens * act_unit * cfg.n_layers
        return pbytes + cache + act
    # decode
    cache = 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2
    return pbytes + cache


# --------------------------------------------------------------------------
# query-kernel rooflines: achieved vs peak bandwidth per fused kernel
# --------------------------------------------------------------------------
# Minimum-traffic models of the reference's tiled kernel family: each
# counts the bytes a perfect cache would still have to move (every input
# once, every output once).  ``chip_smoke.byte_and_op_counts`` holds its
# own counts for the port's kernels; two of them differ from these
# (ROADMAP A.1).

def bytes_box_hits_tiled(n: int, nq: int, d: int,
                         box_bytes: int = 4) -> int:
    """(n boxes x nq windows) intersection-mask kernel traffic.

    ``box_bytes=2`` models the compressed bf16-MBB layout."""
    return 2 * n * d * box_bytes + 2 * nq * d * 4 + n * nq * 4


def bytes_pair_window_ids(p: int, s: int, d: int) -> int:
    """Fused (query, leaf) pair window scan: per pair one leaf block of
    points + ids + count + one query box in, one id row + count out."""
    per_pair = s * d * 4 + s * 4 + 4 + 2 * d * 4 + s * 4 + 4
    return p * per_pair


def bytes_leaf_mindist_tiled(nq: int, n_l: int, d: int,
                             box_bytes: int = 4) -> int:
    """(nq x L) squared-mindist kernel traffic."""
    return 2 * n_l * d * box_bytes + nq * d * 4 + nq * n_l * 4


def bytes_pair_dist2(p: int, s: int, d: int) -> int:
    """Fused (query, leaf) candidate-distance kernel traffic."""
    per_pair = s * d * 4 + 4 + d * 4 + s * 4
    return p * per_pair


def kernel_roofline(bytes_moved: float, seconds: float,
                    bw: float = HBM_BW) -> dict:
    """Achieved-vs-peak bandwidth for one kernel invocation (``bw``: the
    H100's HBM rate unless given)."""
    if seconds <= 0:
        raise ValueError("seconds must be positive")
    achieved = bytes_moved / seconds
    return {
        "bytes": float(bytes_moved),
        "seconds": float(seconds),
        "achieved_gbps": achieved / 1e9,
        "peak_gbps": bw / 1e9,
        "peak_fraction": achieved / bw,
    }


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int, *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW, link_bw: float = NVLINK_BW) -> dict:
    compute_s = flops / (chips * peak_flops)
    memory_s = hbm_bytes / (chips * hbm_bw)
    collective_s = coll_bytes / (chips * link_bw)
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    bound = max(compute_s, memory_s, collective_s)
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms
