"""RWKV-6 (Finch) 7B: attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv", n_layers=32, d_model=4096,
    n_heads=0, n_kv_heads=0, head_dim=64, d_ff=14336, vocab_size=65536,
    layer_pattern="r", rwkv_head_dim=64, source="arXiv:2404.05892",
)
