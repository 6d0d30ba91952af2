"""Architecture registry: --arch <id> resolution (the port's copy of
``repro.configs.registry``)."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .deepseek_7b import CONFIG as _deepseek_7b
from .qwen3_8b import CONFIG as _qwen3_8b
from .granite_20b import CONFIG as _granite_20b
from .gemma2_9b import CONFIG as _gemma2_9b
from .recurrentgemma_9b import CONFIG as _recurrentgemma_9b
from .whisper_small import CONFIG as _whisper_small
from .phi35_moe import CONFIG as _phi35_moe
from .deepseek_moe_16b import CONFIG as _deepseek_moe_16b
from .pixtral_12b import CONFIG as _pixtral_12b
from .rwkv6_7b import CONFIG as _rwkv6_7b

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    _deepseek_7b, _qwen3_8b, _granite_20b, _gemma2_9b,
    _recurrentgemma_9b, _whisper_small, _phi35_moe,
    _deepseek_moe_16b, _pixtral_12b, _rwkv6_7b,
]}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """The registered config ``name``; ``smoke`` gives its reduced
    same-family version for CPU tests."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[name]
    return cfg.smoke() if smoke else cfg
