"""qwen3-0.6b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    tied_embeddings=True,
))
