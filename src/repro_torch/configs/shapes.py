"""Assigned input shapes and the (arch x shape) cell enumeration.

Shapes (per the assignment):

=============  =========  ============  =========================
shape          seq_len    global_batch  lowers
=============  =========  ============  =========================
train_4k       4,096      256           train_step
prefill_32k    32,768     32            prefill (serve forward)
decode_32k     32,768     128           serve_step (1 new token,
                                        KV cache of seq_len)
long_500k      524,288    1             serve_step, sub-quadratic
                                        archs only
=============  =========  ============  =========================

``long_500k`` is skipped for any architecture with at least one full-
attention layer (see DESIGN.md Section 4); no assigned arch is encoder-
only, so decode shapes run everywhere.

The port's copy of ``repro.configs.shapes``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .base import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "cells_for", "all_cells"]


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape: sequence length, global batch and the
    step it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether ``shape`` runs on ``cfg``, and why not when it does not."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch: 500k context is quadratic"
    return True, ""


def cells_for(cfg: ModelConfig) -> List[ShapeSpec]:
    """The shapes that apply to ``cfg``."""
    return [s for s in SHAPES if shape_applicable(cfg, s)[0]]


def all_cells() -> List[Tuple[str, str]]:
    """Every applicable (arch, shape) pair, by name."""
    from .registry import ARCHS
    out = []
    for name, cfg in ARCHS.items():
        for s in cells_for(cfg):
            out.append((name, s.name))
    return out
