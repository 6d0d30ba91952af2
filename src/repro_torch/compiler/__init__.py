"""Optimizing pass pipeline + program cache for PIM schedules.

Sits between the hand-written program builders (``core/multpim.py``,
``core/matvec.py``, ``core/baselines.py``) and the executors
(``core/executor.py``, ``kernels/``):

* :mod:`.depgraph` / :mod:`.liveness` — def-use + live-segment analysis
  across cycles under MAGIC read-modify-write semantics;
* :mod:`.passes` — FELIX-style op fusion (opt-in), dead-INIT
  elimination, INIT coalescing, cycle compaction, cell-lifetime column
  remapping (:func:`optimize`);
* :mod:`.schedule` — critical-path list scheduler over the hazard DAG
  (``PassConfig(scheduler="list")``), never worse than greedy
  compaction and strictly better on serial-movement schedules;
* :mod:`.macrocycle` — macro-cycle fusion for the bit-plane packed
  executors: runs of consecutive cycles (always static-column by
  construction of the packed tables) fuse into one kernel step, so the
  packed executors loop over ``O(T/factor)`` steps
  (:func:`fuse_macrocycles`);
* :mod:`.verify` — differential bit-exactness proof vs ``run_numpy``;
* :mod:`.spec` — :class:`OpSpec`, the canonical hashable identity of a
  compiled program (sorted/frozen flags + pass key + content hash);
* :mod:`.cache` — OpSpec-keyed compile->optimize->verify->pack
  memoization so each spec compiles once per process and the executors
  receive pre-packed, identity-stable tables.

This is the port's own copy of ``repro.compiler``. Co-scheduling
(``coschedule.py``) and the disk cache (``diskcache.py``,
``serialize.py``) are not ported yet: the cache here is memory-only.

The public device/executable facade over this pipeline is
:mod:`repro_torch.engine` — new code should compile through an
:class:`~repro_torch.engine.Engine` rather than calling :func:`compile_cached`
directly.
"""
from .cache import (CompiledEntry, ProgramCache, cache_stats, clear_cache,
                    compile_cached, register_builder)
from .depgraph import DepGraph
from .liveness import dead_sets, live_segments
from .macrocycle import (DEFAULT_MACRO_FACTOR, MacroTables,
                         fuse_macrocycles)
from .passes import OptStats, PassConfig, fuse_ops, optimize
from .schedule import build_op_graph, critical_path, list_schedule
from .spec import PIPELINE_VERSION, OpSpec
from .verify import VerifyReport, verify_equivalence, verify_or_raise

__all__ = [
    "optimize", "PassConfig", "OptStats", "fuse_ops",
    "list_schedule", "build_op_graph", "critical_path",
    "DepGraph", "live_segments", "dead_sets",
    "fuse_macrocycles", "MacroTables", "DEFAULT_MACRO_FACTOR",
    "verify_equivalence", "verify_or_raise", "VerifyReport",
    "compile_cached", "register_builder", "CompiledEntry", "ProgramCache",
    "cache_stats", "clear_cache",
    "OpSpec", "PIPELINE_VERSION",
]
