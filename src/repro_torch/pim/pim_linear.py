"""PIMLinear: a linear layer executed with MultPIM fixed-point semantics.

Three numerically-linked execution paths:

1. ``mode="float"`` — plain float matmul (training / baseline).
2. ``mode="pim"`` — quantize activations+weights to N bits, integer
   matmul (bit-identical to what the in-memory MultPIM-MAC computes),
   dequantize; ``use_pallas=True`` takes the integer product through
   the bit-serial matmul kernel K3 instead (the name is the reference
   package's, whose kernel was written in Pallas).
3. ``mode="fake"`` — quantize-dequantize with a float matmul
   (straight-through estimator for PIM-aware finetuning).

Every PIMLinear also knows its Section-VI crossbar cost
(:func:`repro_torch.core.costmodel.gemm_cost`), which the planner
aggregates into per-model PIM latency/area reports. The port's copy of
``repro.pim.pim_linear``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costmodel import CrossbarSpec, GemmCost, gemm_cost

__all__ = ["PIMLinearSpec", "pim_linear_apply"]


@dataclass(frozen=True)
class PIMLinearSpec:
    """One linear layer's shape, width and execution mode."""

    in_dim: int
    out_dim: int
    n_bits: int = 8
    mode: str = "float"           # float | pim | fake
    use_pallas: bool = False      # route the int matmul through K3
    # Which block-plan scope this linear belongs to ("head" | "ffn" |
    # "attn") — the co-scheduled crossbar group it shares passes with
    # under full-block serving (repro_torch.pim.planner.plan_block).
    scope: str = "head"

    def cost(self, batch_rows: int,
             spec: CrossbarSpec = CrossbarSpec()) -> GemmCost:
        """Section-VI crossbar cost of ``batch_rows`` rows through this
        linear."""
        return gemm_cost(batch_rows, self.in_dim, self.out_dim,
                         self.n_bits, spec=spec)

    def as_block_linear(self) -> "BlockLinear":
        """This spec as the planner's inventory record."""
        from .planner import BlockLinear
        return BlockLinear(name=f"{self.scope}.linear", scope=self.scope,
                           in_dim=self.in_dim, out_dim=self.out_dim)


def pim_linear_apply(spec: PIMLinearSpec, x, w, b=None):
    """x (..., in_dim) @ w (in_dim, out_dim) under the chosen mode.

    Deprecation shim for :meth:`repro_torch.engine.Engine.linear`: every
    PIM-mode linear in the process runs through the one shared Engine
    (:func:`~repro_torch.engine.get_engine`, on the card), so the
    Section-VI MAC schedule for ``spec.n_bits`` compiles exactly once
    and the cost model rides the same verified program.
    """
    from repro_torch.engine import get_engine
    return get_engine().linear(x, w, b, n_bits=spec.n_bits, mode=spec.mode,
                               use_pallas=spec.use_pallas)
