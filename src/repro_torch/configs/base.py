"""Model / run configuration dataclasses and the architecture registry."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e4

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_dff: int = 0            # expert hidden size (d_ff used for dense path)
    moe_every: int = 1          # MoE FFN every k-th layer (jamba: 2)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # local/global attention mix (gemma3)
    local_window: int = 0       # sliding window size; 0 = all-global
    local_per_global: int = 0   # e.g. 5 -> pattern [5 x local, 1 x global]

    # hybrid (jamba): attention every k-th layer, rest mamba
    attn_every: int = 0         # e.g. 8 -> 1 attention + 7 mamba per block
    mamba_d_state: int = 64
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    # rwkv
    rwkv_head_dim: int = 64
    # enc-dec
    encoder_layers: int = 0     # >0 => encoder-decoder (seamless)
    frontend: str = "none"      # none | patch_stub | audio_stub

    tied_embeddings: bool = False

    # performance knobs (hillclimb levers; see EXPERIMENTS.md §Perf)
    local_slice_opt: bool = False  # sliced-KV local attention (vs masked)

    # numeric / structure
    dtype: str = "bfloat16"
    chunk_q: int = 1024         # attention query-chunk (prefill/train)
    la_chunk: int = 64          # linear-attention chunk (rwkv/mamba)
    norm_eps: float = 1e-6

    @property
    def kv_repeat(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so embedding/logit shards tile evenly across the
        16-way model axis (Megatron-style padding; padded ids are masked)."""
        return -(-self.vocab // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def superblock(self) -> int:
        """Layers per scanned repeating block."""
        if self.attn_every:
            return self.attn_every
        if self.local_per_global:
            return self.local_per_global + 1
        return 1

    @property
    def n_blocks(self) -> int:
        base = self.n_layers
        return base // self.superblock

    @property
    def remainder_layers(self) -> int:
        return self.n_layers - self.n_blocks * self.superblock

    def layer_kinds(self) -> list[str]:
        """Sequence-mixer kind for each position inside a superblock."""
        sb = self.superblock
        if self.attn_every:
            return ["attn"] + ["mamba"] * (sb - 1)
        if self.family == "rwkv":
            return ["rwkv"]
        if self.local_per_global:
            return ["local"] * self.local_per_global + ["global"]
        return ["global"]

    def ffn_kinds(self) -> list[str]:
        """FFN kind per position inside a superblock."""
        sb = self.superblock
        if self.n_experts and self.moe_every > 1:
            out = []
            for i in range(sb):
                out.append("moe" if i % self.moe_every == 1 else "dense")
            return out
        if self.n_experts:
            return ["moe"] * sb
        if self.family == "rwkv":
            return ["rwkv_cm"]  # channel-mix
        return ["dense"] * sb

    def params_count(self) -> tuple[int, int]:
        """(total, active) parameter counts (analytic, embeddings included)."""
        hd = self.hd
        d = self.d_model
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + \
            self.n_heads * hd * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = 3 * d * (self.moe_dff or self.d_ff)
        mamba_inner = self.mamba_expand * d
        mamba = d * (2 * mamba_inner) + mamba_inner * 4 + \
            2 * mamba_inner * self.mamba_d_state + mamba_inner * d + \
            mamba_inner * 2
        rwkv_tm = 5 * d * d  # r,k,v,g,o (+ small decay LoRA)
        rwkv_cm = 2 * d * self.d_ff + d * d  # k, v, r
        total = active = 0
        kinds = self.layer_kinds()
        ffns = self.ffn_kinds()
        sb = self.superblock
        n_full = self.n_layers if self.encoder_layers == 0 else self.n_layers
        for i in range(n_full):
            k = kinds[i % sb]
            f = ffns[i % sb]
            if k in ("attn", "local", "global"):
                total += attn
                active += attn
            elif k == "mamba":
                total += mamba
                active += mamba
            elif k == "rwkv":
                total += rwkv_tm
                active += rwkv_tm
            if f == "dense":
                total += dense_ffn
                active += dense_ffn
            elif f == "rwkv_cm":
                total += rwkv_cm
                active += rwkv_cm
            elif f == "moe":
                total += self.n_experts * moe_ffn + d * self.n_experts
                active += self.moe_top_k * moe_ffn + d * self.n_experts
                if self.dense_residual:
                    total += dense_ffn
                    active += dense_ffn
        if self.encoder_layers:
            # encoder self-attn + ffn, decoder adds cross-attention
            enc = self.encoder_layers * (attn + dense_ffn)
            total += enc + self.n_layers * attn  # cross-attn in decoder
            active += enc + self.n_layers * attn
        emb = self.vocab * d * (1 if self.tied_embeddings else 2)
        total += emb
        active += emb
        return total, active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs for which long_500k applies (sub-quadratic attention path);
# see DESIGN.md section 5 for the skip rationale of the rest.
LONG_CONTEXT_ARCHS = {"rwkv6-3b", "jamba-v0.1-52b", "gemma3-27b"}


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def all_configs() -> dict:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


def load_all() -> None:
    from . import (  # noqa: F401
        arctic_480b,
        gemma3_27b,
        internlm2_20b,
        internvl2_2b,
        jamba_52b,
        qwen3_0_6b,
        qwen3_1_7b,
        qwen3_moe_235b,
        rwkv6_3b,
        seamless_m4t_medium,
    )


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped long_500k cells excluded
    unless requested."""
    out = []
    for name, cfg in sorted(all_configs().items()):
        for sname, shape in SHAPES.items():
            skip = None
            if sname == "long_500k" and name not in LONG_CONTEXT_ARCHS:
                skip = "pure full-attention arch: no sub-quadratic path"
            if skip and not include_skipped:
                continue
            out.append((cfg, shape, skip))
    return out
