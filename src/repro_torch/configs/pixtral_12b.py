"""Pixtral-12B: mistral-nemo decoder backbone; pixtral-ViT frontend
stubbed to precomputed patch embeddings [hf:mistralai/Pixtral-12B-2409]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=131072,
    layer_pattern="g", n_patches=256, rope_theta=1e6,
    source="hf:mistralai/Pixtral-12B-2409",
)
