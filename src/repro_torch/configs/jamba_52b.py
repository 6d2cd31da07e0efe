"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2 on
alternate layers [arXiv:2403.19887; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,          # 4 superblocks of (1 attn + 7 mamba)
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    moe_top_k=2,
    moe_dff=14336,
    moe_every=2,          # MoE FFN on alternate layers
    attn_every=8,
    mamba_d_state=64,
    mamba_head_dim=64,
    mamba_expand=2,
))
