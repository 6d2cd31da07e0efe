"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,         # GQA kv=4
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    n_experts=128,
    moe_top_k=8,
    moe_dff=1536,
))
