"""Phi-3.5-MoE (42B total / 6.6B active): 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="decoder", n_layers=32,
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
    layer_pattern="m", moe=MoEConfig(n_experts=16, top_k=2, n_shared=0),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
