"""DeepSeekMoE-16B: fine-grained 64 routed experts top-6 + 2 shared,
first layer dense [arXiv:2401.06066; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="decoder", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400,
    layer_pattern="d" + "m" * 27,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_dense=10944),
    source="arXiv:2401.06066",
)
