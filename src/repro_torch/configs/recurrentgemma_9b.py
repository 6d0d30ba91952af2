"""RecurrentGemma-9B (Griffin): RG-LRU blocks + local attention, 2:1
pattern [arXiv:2402.19427]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
    layer_pattern="rrl", window=2048, source="arXiv:2402.19427",
)
