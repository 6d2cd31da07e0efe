"""arctic-480b — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,         # GQA kv=8
    d_ff=4864,            # dense-residual FFN hidden
    vocab=32000,
    n_experts=128,
    moe_top_k=2,
    moe_dff=4864,
    dense_residual=True,  # arctic's dense-MoE hybrid: parallel residual FFN
))
