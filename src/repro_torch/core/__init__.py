"""MultPIM core: stateful-logic ISA, cycle-accurate simulator, algorithms.

The port's own copy of ``repro.core``, without the JAX executor.

Public surface:

* :mod:`repro_torch.core.isa` / :mod:`repro_torch.core.program` /
  :mod:`repro_torch.core.executor` — the partitioned-crossbar machine model;
* :mod:`repro_torch.core.multpim` — the paper's multiplier (Table I/II exact);
* :mod:`repro_torch.core.matvec` — the Section-VI fused-MAC / mat-vec;
* :mod:`repro_torch.core.adders` — the novel 5/4-cycle FA, 5N ripple adder;
* :mod:`repro_torch.core.baselines` — Haj-Ali and RIME;
* :mod:`repro_torch.core.costmodel` — closed-form tables + crossbar tiling.
"""
from .isa import Gate, Op
from .program import Layout, Program, ProgramBuilder
from .executor import run_numpy, pack_program, PackedProgram
from .multpim import (multpim_multiplier, multpim_latency_formula,
                      multpim_area_formula)
from .matvec import multpim_mac, matvec, inner_product
from .adders import full_adder_program, felix_full_adder_program, ripple_adder
from .baselines import hajali_multiplier, rime_multiplier
from .costmodel import gemm_cost, CrossbarSpec, ALGOS

__all__ = [
    "Gate", "Op", "Layout", "Program", "ProgramBuilder",
    "run_numpy", "pack_program", "PackedProgram",
    "multpim_multiplier", "multpim_latency_formula", "multpim_area_formula",
    "multpim_mac", "matvec", "inner_product",
    "full_adder_program", "felix_full_adder_program", "ripple_adder",
    "hajali_multiplier", "rime_multiplier",
    "gemm_cost", "CrossbarSpec", "ALGOS",
]
