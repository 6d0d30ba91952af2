"""Keyed compile -> optimize -> verify -> pack cache.

Hand-written builders re-generate, re-validate and re-pack the same
static schedule on every call — compile cost paid per request. This
module makes compilation a once-per-key event: the first request for an
:class:`~repro_torch.compiler.spec.OpSpec` builds the program, runs the pass
pipeline, differentially verifies the result against the unoptimized
program, packs the dense executor tables, and memoizes everything; every
later request returns the exact same :class:`CompiledEntry` (identical
packed tables, zero rebuild cost). The executors therefore see stable
table identities, which keeps their device-table memos warm.

Keys are :class:`OpSpec` values — canonicalized flags, so permuted or
differently-constructed flag dicts land on the same entry. Verified
entries additionally spill to the on-disk cache (:mod:`.diskcache`, the
``torch/`` subdirectory of ``REPRO_CACHE_DIR``): a cold process that
finds a spilled artifact skips build, optimize *and* verify (counted in
:func:`cache_stats` as ``disk_hits``).

Thread-safe; keys are fully value-based so distinct flag/config combos
coexist.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

from repro_torch import obs
from repro_torch.core.executor import PackedProgram, pack_program
from repro_torch.core.program import Program

from .passes import OptStats, PassConfig, optimize
from .spec import OpSpec
from .verify import VerifyReport, verify_or_raise

__all__ = ["CompiledEntry", "ProgramCache", "compile_cached",
           "register_builder", "cache_stats", "clear_cache", "BUILDERS",
           "OpSpec"]


# Process-lifetime instruments (module-level so the hot path skips the
# registry lookup; obs.reset_metrics() zeroes them in place). Every
# ProgramCache instance feeds the same counters — they answer "what did
# this process's compile layer do", which Engine.stats()/obs.dump()
# report alongside the per-cache hit/miss fields.
_MET_MEM_HIT = obs.counter("cache.memory_hit")
_MET_MISS = obs.counter("cache.miss")
_MET_DISK_HIT = obs.counter("cache.disk_hit")
_MET_COMPILE = obs.counter("cache.compile")
_MET_VERIFY = obs.counter("cache.verify")
_MET_VERIFY_FAIL = obs.counter("cache.verify_fail")
_MET_COMPILE_MS = obs.histogram("cache.compile_ms")
_MET_VERIFY_MS = obs.histogram("cache.verify_ms")


def _default_builders() -> Dict[str, Callable[..., Program]]:
    # Imported lazily so repro_torch.core never needs repro_torch.compiler
    # at import time (core modules call into the cache from function
    # bodies only).
    from repro_torch.core.baselines import hajali_multiplier, rime_multiplier
    from repro_torch.core.matvec import multpim_mac
    from repro_torch.core.multpim import multpim_multiplier
    from repro_torch.core.multpim_area import multpim_area_multiplier
    from repro_torch.core.residue import residue_program
    from repro_torch.core.staging import recomb_program, stage_program
    return {
        "multpim": multpim_multiplier,
        "multpim_mac": multpim_mac,
        "hajali": hajali_multiplier,
        "rime": rime_multiplier,
        "multpim_area": multpim_area_multiplier,
        "stage": stage_program,
        "recomb": recomb_program,
        "residue": residue_program,
    }


BUILDERS: Dict[str, Callable[..., Program]] = {}

# Kinds whose builder was registered at runtime. Their artifacts never
# touch the disk cache: the on-disk key hashes only (OpSpec, pipeline
# version), not builder identity, so a custom builder's spill would
# poison stock processes sharing the cache dir (and vice versa).
_CUSTOM_KINDS: set = set()


def register_builder(kind: str, builder: Callable[..., Program]) -> None:
    """Expose a new program generator to :func:`compile_cached`.

    Re-registering an existing kind evicts that kind's cached entries
    (memory *and* disk), so the next compile uses the new builder.
    Custom kinds are memory-cached only (see ``_CUSTOM_KINDS``)."""
    BUILDERS[kind] = builder
    _CUSTOM_KINDS.add(kind)
    _GLOBAL.evict_kind(kind)


@dataclass
class CompiledEntry:
    """One compiled program: the raw build, the optimized program, its
    packed tables, the pass statistics and (once run) the verify
    report."""

    key: OpSpec
    raw: Program                  # as built (reference for verification)
    program: Program              # after the pass pipeline
    packed: PackedProgram         # dense tables for the scan/Pallas path
    stats: OptStats
    verified: Optional[VerifyReport] = None
    from_disk: bool = False       # loaded pre-verified from the disk cache

    @classmethod
    def adhoc(cls, prog: Program) -> "CompiledEntry":
        """Wrap an already-built Program as an uncached, unoptimized
        entry (legacy shims and per-call-rebuild benchmarks)."""
        return cls(key=OpSpec(kind=prog.name, n=0), raw=prog, program=prog,
                   packed=pack_program(prog), stats=OptStats(name=prog.name))


def _as_spec(spec_or_kind: Union[OpSpec, str], n: Optional[int],
             flags, config) -> OpSpec:
    if isinstance(spec_or_kind, OpSpec):
        if n is not None or flags is not None or config is not None:
            raise TypeError("pass either an OpSpec or (kind, n, flags, "
                            "config), not both")
        return spec_or_kind
    if n is None:
        raise TypeError("n is required when compiling by kind name")
    return OpSpec.make(spec_or_kind, n, flags, config)


class ProgramCache:
    """Thread-safe, OpSpec-keyed memo of :class:`CompiledEntry` values;
    with ``use_disk`` it loads on a miss from, and spills verified
    entries to, the disk cache (:mod:`.diskcache`)."""

    def __init__(self, use_disk: bool = True):
        self._entries: Dict[OpSpec, CompiledEntry] = {}
        self._lock = threading.Lock()
        # Per-key compile/verify serialization (see get_or_compile). A
        # process touches a handful of distinct OpSpecs, so key locks
        # are kept for the cache's lifetime — no GC races.
        self._key_locks: Dict[OpSpec, threading.Lock] = {}
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.compiles = 0             # actual build+optimize events
        self.use_disk = use_disk

    def _key_lock(self, spec: OpSpec) -> threading.Lock:
        with self._lock:
            kl = self._key_locks.get(spec)
            if kl is None:
                kl = self._key_locks[spec] = threading.Lock()
            return kl

    def get_or_compile(self, spec_or_kind: Union[OpSpec, str],
                       n: Optional[int] = None, *,
                       flags: Optional[Dict] = None,
                       config: Optional[PassConfig] = None,
                       verify: bool = True) -> CompiledEntry:
        """The entry for a spec: memoized, compiled on first request,
        and differentially verified once when ``verify`` is set."""
        spec = _as_spec(spec_or_kind, n, flags, config)
        with self._lock:
            ent = self._entries.get(spec)
        if ent is not None and (not verify or ent.verified is not None):
            # Fast path: verified (or verification not requested) entry
            # already cached — no key lock on the steady-state hot path.
            with self._lock:
                self.hits += 1
            _MET_MEM_HIT.inc()
            return ent

        # Slow path — compile-miss and/or first verification. Serialized
        # per OpSpec key: concurrent scheduler threads that miss the same
        # key must not each build+verify the program (wasted minutes at
        # large n) nor race each other's disk spill — one thread does the
        # work, the rest block here and adopt its entry. Distinct keys
        # still compile fully in parallel.
        with self._key_lock(spec):
            with self._lock:
                ent = self._entries.get(spec)
                if ent is not None:
                    self.hits += 1
                else:
                    self.misses += 1
            if ent is not None:
                _MET_MEM_HIT.inc()
            else:
                _MET_MISS.inc()
                ent = self._load_or_compile(spec)
                with self._lock:
                    ent = self._entries.setdefault(spec, ent)
            if verify and ent.verified is None:
                # Verified lazily, once per entry; verify=False requests
                # are happily served by an already-verified entry. A
                # failed verification evicts the entry so nothing —
                # including later verify=False calls — can be served a
                # known-bad program.
                t0 = time.perf_counter()
                try:
                    with obs.span("cache.verify", kind=spec.kind,
                                  n=spec.n):
                        ent.verified = verify_or_raise(ent.raw, ent.program)
                except Exception:
                    _MET_VERIFY_FAIL.inc()
                    with self._lock:
                        self._entries.pop(spec, None)
                    raise
                _MET_VERIFY.inc()
                _MET_VERIFY_MS.observe((time.perf_counter() - t0) * 1e3)
                self._spill(spec, ent)
        return ent

    # ------------------------------------------------------- internals ----
    def _load_or_compile(self, spec: OpSpec) -> CompiledEntry:
        # Runs under the per-key lock, outside the cache-wide lock (it
        # can take a while for large n): same-key callers wait and adopt,
        # different keys compile concurrently.
        if self.use_disk and spec.kind not in _CUSTOM_KINDS:
            from .diskcache import load_entry
            with obs.span("cache.disk_load", kind=spec.kind, n=spec.n):
                ent = load_entry(spec)
            if ent is not None:
                with self._lock:
                    self.disk_hits += 1
                _MET_DISK_HIT.inc()
                return ent
        if spec.kind not in BUILDERS:
            for k, v in _default_builders().items():
                BUILDERS.setdefault(k, v)
        if spec.kind not in BUILDERS:
            raise KeyError(f"unknown program kind '{spec.kind}' "
                           f"(known: {sorted(BUILDERS)})")
        t0 = time.perf_counter()
        with obs.span("cache.compile", kind=spec.kind, n=spec.n) as sp:
            with obs.span("compile.build", kind=spec.kind, n=spec.n):
                raw = BUILDERS[spec.kind](spec.n, **spec.flags_dict())
            prog, stats = optimize(raw, spec.pass_config())
            with obs.span("compile.pack"):
                packed = pack_program(prog)
            sp.set(cycles=prog.n_cycles, memristors=prog.n_memristors)
        _MET_COMPILE.inc()
        _MET_COMPILE_MS.observe((time.perf_counter() - t0) * 1e3)
        with self._lock:
            self.compiles += 1
        return CompiledEntry(key=spec, raw=raw, program=prog,
                             packed=packed, stats=stats)

    def _spill(self, spec: OpSpec, ent: CompiledEntry) -> None:
        if (self.use_disk and not ent.from_disk
                and spec.kind not in _CUSTOM_KINDS):
            from .diskcache import store_entry
            store_entry(spec, ent)

    # -------------------------------------------------------- management ----
    def evict_kind(self, kind: str) -> None:
        """Drop every cached entry of ``kind`` (and, with ``use_disk``,
        its disk entries)."""
        with self._lock:
            for key in [k for k in self._entries if k.kind == kind]:
                del self._entries[key]
        if self.use_disk:
            from .diskcache import purge_kind
            purge_kind(kind)

    def stats(self) -> Dict[str, int]:
        """Entry count plus hit/miss/disk-hit/compile counters."""
        with self._lock:
            return {"entries": len(self._entries),
                    "hits": self.hits, "misses": self.misses,
                    "disk_hits": self.disk_hits,
                    "compiles": self.compiles}

    def clear(self) -> None:
        """Drop every entry and zero the counters."""
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.disk_hits = self.compiles = 0


_GLOBAL = ProgramCache()


def compile_cached(spec_or_kind: Union[OpSpec, str],
                   n: Optional[int] = None, *,
                   flags: Optional[Dict] = None,
                   config: Optional[PassConfig] = None,
                   verify: bool = True) -> CompiledEntry:
    """Process-wide memoized compile, by :class:`OpSpec` or by
    ``(kind, n, flags, config)`` (legacy form — canonicalized into a
    spec internally, so permuted flag dicts share one entry)."""
    return _GLOBAL.get_or_compile(spec_or_kind, n, flags=flags,
                                  config=config, verify=verify)


def cache_stats() -> Dict[str, int]:
    """Counters of the process-wide cache."""
    return _GLOBAL.stats()


def clear_cache() -> None:
    """Empty the process-wide cache."""
    _GLOBAL.clear()
