"""Configuration files (``bench/configs/<name>.json``) to the port's
:class:`repro_torch.configs.base.ModelConfig`.

A file holds the published ``config.json`` keys of the model (Hugging
Face names), each one as it is run, plus a ``pim`` group with the PIM
flags the port's launcher sets for ``--pim --pim-scope full --pim-bits
8``. Dense llama-style decoders and DeepSeekMoE (one leading dense layer,
then MoE layers) are both read here.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

__all__ = ["load_config_file", "model_config"]


def load_config_file(path: Path) -> Dict[str, Any]:
    """The JSON object in ``path``."""
    with open(path) as f:
        return json.load(f)


def model_config(spec: Dict[str, Any], name: str):
    """The port's ``ModelConfig`` of the configuration ``spec``."""
    from repro_torch.configs.base import MoEConfig, ModelConfig
    if spec.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{name}: only SwiGLU (silu) MLPs are read")
    n_layers = int(spec["num_hidden_layers"])
    moe = None
    pattern = "g"
    d_ff = int(spec["intermediate_size"])
    if spec.get("n_routed_experts"):
        dense = int(spec.get("first_k_dense_replace", 0))
        if int(spec.get("moe_layer_freq", 1)) != 1:
            raise ValueError(f"{name}: moe_layer_freq other than 1")
        moe = MoEConfig(n_experts=int(spec["n_routed_experts"]),
                        top_k=int(spec["num_experts_per_tok"]),
                        n_shared=int(spec.get("n_shared_experts", 0)),
                        d_ff_dense=d_ff)
        d_ff = int(spec["moe_intermediate_size"])
        pattern = "d" * dense + "m" * (n_layers - dense)
    pim = spec.get("pim", {})
    return ModelConfig(
        name=name, family="decoder", n_layers=n_layers,
        d_model=int(spec["hidden_size"]),
        n_heads=int(spec["num_attention_heads"]),
        n_kv_heads=int(spec.get("num_key_value_heads",
                                spec["num_attention_heads"])),
        d_ff=d_ff, vocab_size=int(spec["vocab_size"]),
        layer_pattern=pattern, rope_theta=float(spec["rope_theta"]),
        moe=moe, tie_embeddings=bool(spec["tie_word_embeddings"]),
        norm_eps=float(spec["rms_norm_eps"]), source=spec["source"],
        pim_linear_mode=pim.get("pim_linear_mode", "off"),
        pim_linear_bits=int(pim.get("pim_linear_bits", 8)),
        pim_block_mode=pim.get("pim_block_mode", "none"))
