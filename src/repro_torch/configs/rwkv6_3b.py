"""rwkv6-3b — Finch: attention-free, data-dependent decay [arXiv:2404.05892; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # time-mix heads (head_dim 64)
    n_kv_heads=40,
    d_ff=8960,            # channel-mix hidden
    vocab=65536,
    head_dim=64,
    rwkv_head_dim=64,
))
