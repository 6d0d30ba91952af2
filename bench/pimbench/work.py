"""Work counts from shapes, and the card's peaks.

They count the work a layer needs, whatever implements it: a later
change that holds the weights quantized or moves the product onto int8
tensor cores cannot push a share past 100%.

Peaks: one NVIDIA H100 SXM as its data sheet gives them, dense: 1,979
TOP/s in int8 (the highest rate any part of a step may run at: the PIM
products are exact 8-bit integer products) and 3.35 TB/s of HBM. They
assume the full 700 W; the card's ``power.limit`` is read at run time
and printed beside every share.
"""
from __future__ import annotations

import subprocess
from typing import Optional, Sequence

__all__ = ["PEAK_OPS", "PEAK_BYTES", "linear_work", "ragged_work",
           "bound_s", "active_params", "model_flops", "power_limit"]

PEAK_OPS = 1979e12       # int8 dense, ops/s
PEAK_BYTES = 3.35e12     # HBM3, bytes/s


def linear_work(m: int, k: int, n: int, n_bits: int):
    """(ops, bytes) of a PIM linear of ``x`` (M, K) and ``w`` (K, N): the
    product's multiply-adds, and the weight at its quantized width (fixed
    for the whole window, so an exact implementation may hold it so),
    ``x`` and the float32 result read and written once, and one float32
    scale a column."""
    ops = 2 * m * k * n
    nbytes = k * n * n_bits / 8 + 4 * m * k + 4 * m * n + 4 * n
    return ops, nbytes


def ragged_work(counts: Sequence[int], k: int, n: int, n_bits: int):
    """(ops, bytes) of a ragged PIM call: ``counts[e]`` rows times expert
    ``e``'s (K, N) weight; only the experts that received rows are read,
    and one float32 scale covers the stack."""
    rows = sum(counts)
    live = sum(1 for c in counts if c)
    ops = 2 * rows * k * n
    nbytes = live * k * n * n_bits / 8 + 4 * rows * k + 4 * rows * n + 4
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the two bounds."""
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


def active_params(cfg) -> int:
    """Parameters a token uses outside the embedding lookup: every
    projection of every layer (a MoE layer's router, its ``top_k``
    routed experts and its shared experts) and the LM head."""
    d = cfg.d_model
    attn = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    total = d * cfg.vocab_size
    for kind in cfg.layer_kinds():
        total += attn
        if kind == "m":
            e = cfg.moe
            total += d * e.n_experts + (e.top_k + e.n_shared) * 3 * d * cfg.d_ff
        elif kind == "d":
            total += 3 * d * (cfg.moe.d_ff_dense or cfg.d_ff)
        else:
            total += 3 * d * cfg.d_ff
    return total


def model_flops(cfg, tokens: int, attended: int) -> float:
    """Model FLOPs of ``tokens`` tokens that attend ``attended``
    positions in all: 2 per active parameter a token, and attention's
    ``4 q_dim`` a token an attended position a layer (scores and the
    weighted sum of values)."""
    return (2.0 * active_params(cfg) * tokens
            + 4.0 * cfg.q_dim * cfg.n_layers * attended)


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
