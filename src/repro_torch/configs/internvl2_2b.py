"""internvl2-2b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

The ViT frontend is a STUB per the brief: ``input_specs()`` feeds
precomputed patch embeddings alongside the token stream."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    frontend="patch_stub",
))
