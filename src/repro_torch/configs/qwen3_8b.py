"""Qwen3-8B: dense GQA decoder with per-head QK-RMSNorm [hf:Qwen/Qwen3-8B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="decoder", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=12288, vocab_size=151936,
    layer_pattern="g", qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
