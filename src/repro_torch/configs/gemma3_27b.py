"""gemma3-27b — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,          # 10 superblocks of (5 local + 1 global) + 2 local
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    qk_norm=True,
    local_window=1024,
    local_per_global=5,
))
