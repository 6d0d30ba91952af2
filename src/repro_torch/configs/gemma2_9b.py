"""Gemma2-9B: local/global alternating attention + logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="decoder", n_layers=42, d_model=3584,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336, vocab_size=256000,
    layer_pattern="lg", window=4096, softcap_attn=50.0, softcap_final=30.0,
    source="arXiv:2408.00118",
)
