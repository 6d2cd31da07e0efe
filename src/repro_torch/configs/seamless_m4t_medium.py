"""seamless-m4t-medium — encoder-decoder, multimodal [arXiv:2308.11596; hf].

The audio frontend is a STUB per the brief: ``input_specs()`` feeds
precomputed frame embeddings to the encoder."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    frontend="audio_stub",
))
