"""DeepSeek-7B: dense llama-arch MHA decoder [arXiv:2401.02954; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="decoder", n_layers=30, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=102400,
    layer_pattern="g", source="arXiv:2401.02954",
)
