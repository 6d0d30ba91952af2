"""Whisper-small: encoder-decoder; conv frontend stubbed to precomputed
frame embeddings [arXiv:2212.04356]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
    layer_pattern="g", enc_layers=12, enc_frames=1500,
    mlp_type="gelu", tie_embeddings=True, source="arXiv:2212.04356",
)
