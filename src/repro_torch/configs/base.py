"""Model configuration schema for the assigned architecture pool.

``layer_pattern`` is a repeating string over layer types:
  ``g`` global (full) attention block
  ``l`` local (sliding-window) attention block
  ``r`` recurrent block (RG-LRU for family="hybrid", RWKV-6 for "rwkv")
  ``m`` MoE block (attention + expert FFN)
  ``d`` dense block inside an otherwise-MoE stack
The pattern tiles across ``n_layers`` (trailing partial unit allowed).

The port's copy of ``repro.configs.base``: plain dataclasses, no
weights and nothing to download.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["MoEConfig", "ModelConfig"]


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts widths: routed experts, top-k, shared experts
    and the FFN width of the dense layers inside a MoE stack."""

    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_dense: int = 0        # dense layers inside a MoE stack ('d')


@dataclass(frozen=True)
class ModelConfig:
    """One architecture's published widths and layer pattern, plus the
    PIM offload flags the planner reads."""

    name: str
    family: str                # decoder | encdec | vlm | rwkv | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    layer_pattern: str = "g"
    window: int = 4096                  # sliding window for 'l' layers
    rope_theta: float = 10000.0
    qk_norm: bool = False
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    moe: Optional[MoEConfig] = None
    # enc-dec (whisper): encoder consumes precomputed frame embeddings
    enc_layers: int = 0
    enc_frames: int = 1500
    # vlm (pixtral): stub frontend supplies patch embeddings
    n_patches: int = 0
    # rwkv
    rwkv_head_dim: int = 64
    mlp_type: str = "swiglu"            # swiglu (3 mats) | gelu (2 mats)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    source: str = ""
    # PIM offload: run the LM-head linear under MultPIM fixed-point
    # semantics via the shared repro_torch.engine ("off" | "pim" | "fake").
    pim_linear_mode: str = "off"
    pim_linear_bits: int = 8
    # How much of each *block* also routes through the PIM engine
    # (co-scheduled crossbar groups; see repro_torch.pim.planner):
    #   "none" — only the LM head (pim_linear_mode) is PIM-offloaded
    #   "ffn"  — + both FFN projections (incl. MoE per-expert GEMMs)
    #   "full" — + the attention q/k/v/o projections
    pim_block_mode: str = "none"

    def pim_scopes(self) -> Tuple[str, ...]:
        """Linear scopes routed through the PIM engine under the current
        mode flags (subset of ("head", "ffn", "attn"))."""
        scopes = []
        if self.pim_linear_mode != "off":
            scopes.append("head")
        if self.pim_block_mode in ("ffn", "full"):
            scopes.append("ffn")
        if self.pim_block_mode == "full":
            scopes.append("attn")
        return tuple(scopes)

    @property
    def hd(self) -> int:
        """Per-head width (``head_dim``, else ``d_model / n_heads``)."""
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        """Width of the query projection's output."""
        return self.hd * self.n_heads

    @property
    def kv_dim(self) -> int:
        """Width of the key (and of the value) projection's output."""
        return self.hd * self.n_kv_heads

    def layer_kind(self, i: int) -> str:
        """Layer type of layer ``i`` (the pattern tiled)."""
        return self.layer_pattern[i % len(self.layer_pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        """Layer types of all ``n_layers`` layers."""
        return tuple(self.layer_kind(i) for i in range(self.n_layers))

    @property
    def is_subquadratic(self) -> bool:
        """True when no layer uses full attention (long_500k eligible).

        'm'/'d' blocks carry full attention; enc-dec and VLM backbones
        use full attention over their own streams.
        """
        kinds = set(self.layer_kinds())
        return (kinds <= {"r", "l"} and self.family not in ("encdec", "vlm"))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        nm = 3 if self.mlp_type == "swiglu" else 2
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        kinds = self.layer_kinds()
        for k in kinds:
            if k in ("g", "l"):
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                n += nm * d * self.d_ff
            elif k == "r":
                if self.family == "rwkv":
                    n += 6 * d * d // 1 + 2 * d * self.d_ff
                else:  # RG-LRU
                    n += 2 * d * d + 3 * d + 3 * d * self.d_ff
            elif k == "m":
                e = self.moe
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                n += (e.n_experts + e.n_shared) * nm * d * self.d_ff
                n += d * e.n_experts
            elif k == "d":
                e = self.moe
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                n += nm * d * (e.d_ff_dense or self.d_ff)
            n += 2 * d  # norms
        if self.enc_layers:
            n += self.enc_layers * (4 * d * d + 2 * d * self.d_ff + 4 * d)
        return n

    def scaled(self, **overrides) -> "ModelConfig":
        """A copy with ``overrides`` replaced."""
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        pattern = self.layer_pattern
        if len(pattern) > 4:  # e.g. deepseek-moe's "d" + 27*"m"
            pattern = "".join(dict.fromkeys(pattern))  # unique, in order
        unit = len(pattern)
        layers = max(unit, 2 if unit == 1 else unit)
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, n_experts=min(4, moe.n_experts),
                top_k=min(2, moe.top_k), n_shared=min(1, moe.n_shared),
                d_ff_dense=64 if moe.d_ff_dense else 0)
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=layers,
            layer_pattern=pattern, d_model=64, n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=16, d_ff=128, vocab_size=256, window=32,
            enc_layers=min(2, self.enc_layers), enc_frames=8,
            n_patches=min(4, self.n_patches), moe=moe,
            rwkv_head_dim=16)
