"""Closed-form latency/area models (paper Tables I-III) + crossbar tiling.

Two families of numbers flow through the framework:

* **cited** — the paper's closed forms (and its baselines' closed forms),
  used for all cross-paper comparisons (Tables I, II, III);
* **measured** — our compiler-counted cycles/memristors from the actual
  program schedules (exact for MultPIM/MAC/adders; upper-bound
  reconstructions for Haj-Ali/RIME). Tests assert cited == measured for
  MultPIM and the MultPIM adders.

The tiling model maps a fixed-point GEMM onto crossbar tiles the way
Section VI lays out matrix-vector products (one inner product per row,
vector duplicated down the rows), giving the PIM-side latency/area/energy
proxies that :mod:`repro_torch.pim.planner` attaches to every PIMLinear layer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from . import baselines, multpim
from .matvec import floatpim_matvec_latency, matvec_latency_formula

__all__ = ["ALGOS", "algo_latency", "algo_area", "CrossbarSpec",
           "GemmCost", "gemm_cost", "CYCLE_NS_DEFAULT"]

CYCLE_NS_DEFAULT = 10.0  # memristive stateful-logic cycle (~100 MHz), a
# commonly assumed figure for MAGIC-class gates; configurable everywhere.


def _multpim_area_variant_latency(n: int) -> int:
    return n * math.ceil(math.log2(n)) + 23 * n + 3


def _multpim_area_variant_area(n: int) -> int:
    return 10 * n


ALGOS: Dict[str, Dict] = {
    "hajali": {
        "latency": baselines.hajali_latency_formula,
        "area": baselines.hajali_area_formula,
        "source": "Haj-Ali et al. [19]",
    },
    "rime": {
        "latency": baselines.rime_latency_formula,
        "area": baselines.rime_area_formula,
        "source": "RIME [22]",
    },
    "multpim": {
        "latency": multpim.multpim_latency_formula,
        "area": multpim.multpim_area_formula,
        "source": "MultPIM (this paper)",
    },
    "multpim-area": {
        "latency": _multpim_area_variant_latency,
        "area": _multpim_area_variant_area,
        "source": "MultPIM-Area (this paper)",
    },
}


def algo_latency(name: str, n_bits: int) -> int:
    """Closed-form latency of algorithm ``name`` at ``n_bits``."""
    return ALGOS[name]["latency"](n_bits)


def algo_area(name: str, n_bits: int) -> int:
    """Closed-form area of algorithm ``name`` at ``n_bits``."""
    return ALGOS[name]["area"](n_bits)


# ------------------------------------------------------------- tiling ----
@dataclass(frozen=True)
class CrossbarSpec:
    """Physical crossbar parameters (defaults: common 1024^2 arrays)."""
    rows: int = 1024
    cols: int = 1024
    cycle_ns: float = CYCLE_NS_DEFAULT
    energy_pj_per_gate: float = 0.1   # per gate-row activation (proxy)


@dataclass
class GemmCost:
    """PIM cost of C[M,Nout] = A[M,K] @ B[K,Nout] at n_bits fixed point."""
    m: int
    k: int
    n_out: int
    n_bits: int
    row_tiles: int          # ceil(M / rows)
    k_tiles: int            # K segments per crossbar row (column capacity)
    crossbars: int
    cycles: int             # latency with all crossbars in parallel
    memristors: int
    latency_us: float
    energy_uj: float

    def as_dict(self) -> Dict:
        """Plain-dict form."""
        return self.__dict__.copy()


def gemm_cost(m: int, k: int, n_out: int, n_bits: int = 8,
              spec: CrossbarSpec = CrossbarSpec(),
              algo: str = "multpim-mac") -> GemmCost:
    """Map a GEMM onto Section-VI crossbar mat-vec tiles.

    Layout (paper Fig. 5): each crossbar row holds one row of A (a K x
    n_bits segment) plus the duplicated vector; each of the ``n_out``
    columns of B is processed as one mat-vec pass. Rows beyond the
    crossbar row count and K beyond the column capacity tile into more
    crossbars; cross-tile partial sums use the 5(2N)-cycle ripple adder.
    """
    nb = n_bits
    # columns needed for one full-K row: 2*K*N + 14N + 5 (paper Sec. VI)
    def row_cols(k_seg: int) -> int:
        return 2 * k_seg * nb + 14 * nb + 5

    k_seg = k
    k_tiles = 1
    while row_cols(k_seg) > spec.cols:
        k_tiles += 1
        k_seg = math.ceil(k / k_tiles)
    row_tiles = math.ceil(m / spec.rows)

    if algo == "multpim-mac":
        per_pass = matvec_latency_formula(k_seg, nb)
    elif algo == "floatpim":
        per_pass = floatpim_matvec_latency(k_seg, nb)
    else:
        per_pass = k_seg * algo_latency(algo, nb) + 5 * (2 * nb) * k_seg
    # all row-tiles and k-tiles run in parallel (independent crossbars);
    # n_out passes are sequential; k-tile partial sums reduce in
    # log2(k_tiles) adder steps of 5*(2N+log2 k) cycles each.
    reduce_cycles = 0
    if k_tiles > 1:
        width = 2 * nb + math.ceil(math.log2(max(2, k_tiles)))
        reduce_cycles = math.ceil(math.log2(k_tiles)) * 5 * width
    cycles = n_out * (per_pass + reduce_cycles)

    crossbars = row_tiles * k_tiles
    if algo == "floatpim":
        per_row_cells = 4 * k_seg * nb + 22 * nb - 5
    else:
        per_row_cells = row_cols(k_seg)
    memristors = crossbars * min(m, spec.rows) * per_row_cells
    latency_us = cycles * spec.cycle_ns / 1e3
    # energy proxy: every cycle activates <= one gate per partition per
    # occupied row across all crossbars.
    gates = cycles * min(m, spec.rows) * crossbars
    energy_uj = gates * spec.energy_pj_per_gate / 1e6
    return GemmCost(m, k, n_out, nb, row_tiles, k_tiles, crossbars,
                    cycles, memristors, latency_us, energy_uj)
