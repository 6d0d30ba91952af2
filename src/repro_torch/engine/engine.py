"""Engine: the device facade — compile once, run many, on a chosen backend.

One Engine fronts the whole pipeline: builders -> pass pipeline ->
differential verify -> packed tables (all via the OpSpec-keyed
:mod:`repro_torch.compiler.cache`, including its disk spill) -> a
:class:`~repro_torch.engine.executable.Executable` bound to a
:class:`~repro_torch.engine.backends.Backend`. High-level ops
(``multiply``, ``mac``, ``inner_product``, ``matvec``) are built on that
same compile path, so every caller shares one program cache and one
backend policy.

:meth:`Engine.compile_batch` is the multi-program co-scheduling entry:
K copies of one verified program are relocated into disjoint
partition/column ranges of a single wide crossbar
(:mod:`repro_torch.compiler.coschedule`) and fused into one
:class:`~repro_torch.engine.executable.BatchedExecutable`, so one backend
pass serves K MACs. ``inner_product``/``matvec`` split their element
streams into ``k`` independent carry-save accumulator chains and issue
co-scheduled MAC groups instead of sequential passes.
:meth:`Engine.compile_group` generalizes that to heterogeneous op
lists (a :class:`~repro_torch.engine.executable.GroupedExecutable`),
which is what :mod:`repro_torch.pim.planner` lowers a block's linears
onto.

:meth:`Engine.linear` and :meth:`Engine.ragged_linear` are the PIM
linear layers: quantize, compile the co-scheduled MAC group through the
shared cache, and take the integer product — exact in integers
(:func:`repro_torch.pim.quant.qlinear_exact`, the integers of
:func:`~repro_torch.pim.quant.qmatmul_exact`), or through the
bit-serial matmul kernel K3
(:func:`repro_torch.kernels.bitserial_matmul.bitserial_matmul`) with
``use_pallas=True`` — on the device of the input. In ``pim`` mode a
call is a ``pim.linear`` (``pim.ragged_linear``) span over the phase
spans of :mod:`repro_torch.pim.quant`.

The default backend is :class:`~repro_torch.engine.backends.TorchBackend`
on CUDA with bit-plane packing: the port runs on the card unless the
caller asks for the CPU (``backend="torch:device=cpu"`` or ``"numpy"``).
:meth:`Engine.resident` arms drain-time fault detection
(:mod:`repro_torch.faults`) when the backend carries an active fault
model.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import dist, obs
from repro_torch.core.bits import from_bits, to_bits
from repro_torch.core.costmodel import CrossbarSpec

from .backends import (Backend, backend_fault_model, resolve_backend,
                       supports_resident)
from .executable import (BatchedExecutable, Executable, GroupedExecutable,
                         ResidentExecutable)

__all__ = ["Engine", "get_engine", "OP_KINDS", "DEFAULT_COSCHEDULE_K",
           "GroupSpec"]

# Default co-scheduled MAC group size: 4 MACs per crossbar pass keeps
# the fused 8/16-bit MAC layouts comfortably inside a 1024-column
# crossbar while already cutting cycles-per-MAC ~4x.
DEFAULT_COSCHEDULE_K = 4

# Public op names -> compiler builder kinds.
OP_KINDS: Dict[str, str] = {
    "multpim": "multpim",
    "rime": "rime",
    "hajali": "hajali",
    "mac": "multpim_mac",
    "multpim_mac": "multpim_mac",
    "multpim_area": "multpim_area",
    "stage": "stage",
    "recomb": "recomb",
    "residue": "residue",
}


@dataclass(frozen=True)
class GroupSpec:
    """One member of a heterogeneous co-scheduled group
    (:meth:`Engine.compile_group`): ``copies`` independent slots of op
    ``op`` at width ``n``. ``label`` names the member in per-op cost
    rows (defaults to ``"{op}/n{n}"``); ``flags``/``config`` pass
    through to the compiler exactly as in :meth:`Engine.compile`.
    """

    op: str
    n: int
    copies: int = 1
    label: Optional[str] = None
    flags: Optional[Dict] = None
    config: Optional["PassConfig"] = None

    def __post_init__(self):
        if self.copies < 1:
            raise ValueError("copies >= 1")

    @classmethod
    def of(cls, item: Union["GroupSpec", Tuple, Dict, str]) -> "GroupSpec":
        """Coerce a group member — GroupSpec, ``(op, n[, copies])``
        tuple, or kwargs dict — into a :class:`GroupSpec`."""
        if isinstance(item, cls):
            return item
        if isinstance(item, str):
            raise TypeError(
                f"group member {item!r} needs a width: pass (op, n), "
                f"(op, n, copies), a dict, or a GroupSpec")
        if isinstance(item, dict):
            return cls(**item)
        return cls(*item)


class Engine:
    """Compile-and-execute front end over the PIM stack.

    ``backend`` is the default execution backend (name, spec string or
    instance — see :func:`repro_torch.engine.backends.resolve_backend`;
    ``None`` = packed torch on CUDA); ``cache`` defaults to the
    process-wide program cache so every Engine shares compiled
    artifacts; ``crossbar`` parameterizes the cost model;
    ``coschedule_k`` is the default co-scheduled MAC group size.
    """

    def __init__(self, backend: Union[None, str, Backend] = None, *,
                 cache: Optional["ProgramCache"] = None,
                 crossbar: CrossbarSpec = CrossbarSpec(),
                 pass_config: Optional["PassConfig"] = None,
                 coschedule_k: int = DEFAULT_COSCHEDULE_K):
        from repro_torch.compiler import cache as _cache_mod
        self.backend = resolve_backend(backend)
        self.cache = cache if cache is not None else _cache_mod._GLOBAL
        self.crossbar = crossbar
        self.pass_config = pass_config
        self.coschedule_k = coschedule_k
        self.runs = 0
        self._batch_entries: Dict[Tuple, Tuple] = {}
        self._batch_lock = threading.Lock()
        # inner_product's private ResidentExecutable memo, keyed
        # (n, rows, backend): chains hold device index tensors, so
        # rebuilding per call would re-upload them. Entries are reset
        # before reuse; long-lived chains are built via resident().
        self._resident_memo: Dict[Tuple, ResidentExecutable] = {}

    # -------------------------------------------------------- compile ----
    def compile(self, op: str = "multpim", n: int = 16, *,
                flags: Optional[Dict] = None,
                config: Optional["PassConfig"] = None,
                backend: Union[None, str, Backend] = None,
                verify: bool = True) -> Executable:
        """Compile (or fetch) a named op at width ``n`` -> Executable.

        ``op`` is one of ``multpim | rime | hajali | mac | multpim_area |
        stage | recomb`` or any kind registered with
        :func:`repro_torch.compiler.register_builder`.
        """
        kind = OP_KINDS.get(op, op)
        with obs.span("engine.compile", op=kind, n=n):
            entry = self.cache.get_or_compile(
                kind, n, flags=flags, config=config or self.pass_config,
                verify=verify)
        return Executable(entry, resolve_backend(backend, self.backend),
                          crossbar=self.crossbar, engine=self)

    def compile_batch(self, op: str = "mac", n: int = 16, k: int = 4, *,
                      flags: Optional[Dict] = None,
                      config: Optional["PassConfig"] = None,
                      backend: Union[None, str, Backend] = None,
                      verify: bool = True) -> BatchedExecutable:
        """Co-schedule ``k`` copies of one op into a single crossbar pass.

        The single program compiles (and differentially verifies)
        through the shared cache exactly like :meth:`compile`; the fused
        artifact — ``k`` relocated copies in disjoint partition/column
        ranges with merged cycle streams — is memoized per
        ``(OpSpec, k)`` on this Engine, so repeated traffic reuses one
        packed table. The crossbar's physical column budget
        (``self.crossbar.cols``) bounds ``k``; an oversized request
        raises :class:`repro_torch.compiler.coschedule.CapacityError`.
        """
        if k < 1:
            raise ValueError("k >= 1")
        kind = OP_KINDS.get(op, op)
        with obs.span("engine.compile_batch", op=kind, n=n, k=k):
            entry = self.cache.get_or_compile(
                kind, n, flags=flags, config=config or self.pass_config,
                verify=verify)
            fused_entry, placements = self._fused(
                [entry] * k,
                name=f"coschedule{k}[{entry.program.name}]")
        inner = Executable(fused_entry, resolve_backend(backend,
                                                        self.backend),
                           crossbar=self.crossbar, engine=self)
        return BatchedExecutable(inner, k, placements, entry)

    def _fused(self, entries: List["CompiledEntry"], name: str
               ) -> Tuple["CompiledEntry", List["Placement"]]:
        """Memoized co-schedule of already-compiled entries into one
        fused program with disjoint partition/column ranges. Keyed by
        the ordered member OpSpecs; a memo survives only while every
        base entry is *the same object* — clear_cache() /
        register_builder() can recompile an equal OpSpec into a new
        entry, and a fused program built from the old one must not
        survive that."""
        key = tuple(e.key for e in entries)
        with self._batch_lock:
            memo = self._batch_entries.get(key)
            if memo is not None and any(a is not b
                                        for a, b in zip(memo[0], entries)):
                memo = None
        if memo is None:
            from repro_torch.compiler.cache import CompiledEntry
            from repro_torch.compiler.coschedule import (PartitionAllocator,
                                                         coschedule)
            alloc = PartitionAllocator(max_cols=self.crossbar.cols)
            with obs.span("engine.coschedule", fused=name,
                          k=len(entries)):
                prog, placements = coschedule(
                    [e.program for e in entries], allocator=alloc,
                    name=name)
            memo = (tuple(entries), CompiledEntry.adhoc(prog), placements)
            with self._batch_lock:
                prev = self._batch_entries.get(key)
                if prev is not None and all(a is b for a, b in
                                            zip(prev[0], entries)):
                    memo = prev           # racing fuse: first one wins
                else:
                    self._batch_entries[key] = memo
        _, fused_entry, placements = memo
        return fused_entry, placements

    def compile_group(self, specs: Sequence, *,
                      backend: Union[None, str, Backend] = None,
                      verify: bool = True) -> GroupedExecutable:
        """Co-schedule a **heterogeneous** op list into one crossbar pass.

        ``specs`` is a sequence of group members — :class:`GroupSpec`
        instances, ``(op, n)`` / ``(op, n, copies)`` tuples, or dicts
        with those fields. Each distinct member compiles (and
        differentially verifies) through the shared cache exactly like
        :meth:`compile`; the members are then relocated into disjoint
        partition/column ranges of one wide crossbar and their cycle
        streams merged (:func:`repro_torch.compiler.coschedule.
        coschedule`), so a single backend pass serves every slot. The
        fused artifact is memoized per ordered member-spec tuple on this
        Engine. Raises :class:`repro_torch.compiler.coschedule.
        CapacityError` when the group exceeds the crossbar's column
        budget (``self.crossbar.cols``).
        """
        members = [GroupSpec.of(s) for s in specs]
        if not members:
            raise ValueError("nothing to group")
        with obs.span("engine.compile_group", members=len(members)):
            entries: List["CompiledEntry"] = []
            labels: List[str] = []
            for m in members:
                kind = OP_KINDS.get(m.op, m.op)
                entry = self.cache.get_or_compile(
                    kind, m.n, flags=m.flags,
                    config=m.config or self.pass_config, verify=verify)
                entries.extend([entry] * m.copies)
                labels.extend([m.label or f"{m.op}/n{m.n}"] * m.copies)
            name = "group[" + ",".join(dict.fromkeys(labels)) + "]"
            fused_entry, placements = self._fused(entries, name=name)
        inner = Executable(fused_entry, resolve_backend(backend,
                                                        self.backend),
                           crossbar=self.crossbar, engine=self)
        return GroupedExecutable(inner, placements, entries, labels=labels)

    def group_counts(self, specs: Sequence,
                     weights: Optional[Sequence[float]] = None
                     ) -> List[int]:
        """Heterogeneous-K policy for a group: how many co-scheduled
        copies each member op gets, packed by this crossbar's column
        budget (not a uniform K) and weighted by each member's streamed
        work (:func:`repro_torch.compiler.coschedule.
        column_budget_counts`). The result is clamped so the total does
        not exceed the engine's ``coschedule_k`` policy per member —
        callers feed it straight back as the ``copies`` fields of
        :meth:`compile_group`."""
        from repro_torch.compiler.coschedule import column_budget_counts
        members = [GroupSpec.of(s) for s in specs]
        progs = []
        for m in members:
            kind = OP_KINDS.get(m.op, m.op)
            progs.append(self.cache.get_or_compile(
                kind, m.n, flags=m.flags,
                config=m.config or self.pass_config).program)
        counts = column_budget_counts(progs, self.crossbar.cols,
                                      weights=weights)
        # Respect the engine-wide group-size policy: the crossbar may
        # hold hundreds of narrow MACs, but marshalling cost grows with
        # every extra slot, so cap total slots at coschedule_k per
        # member on average.
        cap = max(len(members), self.coschedule_k * len(members))
        while sum(counts) > cap:
            i = max(range(len(counts)), key=lambda j: counts[j])
            if counts[i] == 1:
                break
            counts[i] -= 1
        return counts

    def max_coschedule_k(self, op: str = "mac", n: int = 16, *,
                         flags: Optional[Dict] = None,
                         config: Optional["PassConfig"] = None) -> int:
        """Largest K the physical crossbar (``self.crossbar.cols``
        columns) can co-schedule for this op/width — 0 when even a
        single copy exceeds the crossbar (callers must then fall back
        to the plain, non-co-scheduled compile)."""
        from repro_torch.compiler.coschedule import PartitionAllocator
        kind = OP_KINDS.get(op, op)
        entry = self.cache.get_or_compile(
            kind, n, flags=flags, config=config or self.pass_config)
        alloc = PartitionAllocator(max_cols=self.crossbar.cols)
        return alloc.capacity(entry.program)

    def k_ladder(self, op: str = "mac", n: int = 16, *,
                 max_k: Optional[int] = None,
                 flags: Optional[Dict] = None,
                 config: Optional["PassConfig"] = None) -> Tuple[int, ...]:
        """The discrete co-schedule group sizes a load-driven scheduler
        may pick from: powers of two up to the crossbar's capacity for
        this op/width (optionally clamped by ``max_k``). Precompiling
        the ladder (one memoized fused entry per rung, see
        :meth:`compile_batch`) makes joining or evicting a sequence a
        slot-assignment change, never a recompile. Empty when even a
        single copy exceeds the crossbar."""
        cap = self.max_coschedule_k(op, n, flags=flags, config=config)
        if max_k is not None:
            cap = min(cap, int(max_k))
        ladder: List[int] = []
        k = 1
        while k <= cap:
            ladder.append(k)
            k *= 2
        return tuple(ladder)

    def effective_coschedule_k(self, op: str = "mac", n: int = 16,
                               requested: Optional[int] = None, *,
                               flags: Optional[Dict] = None,
                               config: Optional["PassConfig"] = None) -> int:
        """The one K-clamp policy every co-scheduling consumer shares:
        the requested group size (default: this engine's
        ``coschedule_k``) bounded by the crossbar's capacity for this
        op/width — measured on the *same* flags/config the caller will
        compile with. Returns 0 when even one copy doesn't fit — callers
        treat < 2 as "co-scheduling off, use the plain compile"."""
        want = self.coschedule_k if requested is None else int(requested)
        return min(want, self.max_coschedule_k(op, n, flags=flags,
                                               config=config))

    def resident(self, n: int, *, rows: int,
                 backend: Union[None, str, Backend] = None,
                 verify: bool = True,
                 detect: Optional[bool] = None) -> ResidentExecutable:
        """``rows`` device-resident carry-save MAC chains (one per
        crossbar row) — see
        :class:`~repro_torch.engine.executable.ResidentExecutable`.

        Compiles the ``mac`` program plus its in-crossbar ``stage`` /
        ``recomb`` companions (:mod:`repro_torch.core.staging`) through
        the shared cache and binds them to a backend chain that keeps
        the accumulator state on the device between passes. The backend
        must support resident execution (numpy always; torch with
        ``pack=true``).

        ``detect`` controls drain-time corruption detection
        (:mod:`repro_torch.faults`): ``None`` (the default policy) turns
        it on exactly when the backend carries an active fault model
        (``faults=<key>`` in its spec), so fault-free runs compile no
        extra program and stay bit-identical; ``True``/``False`` force
        it. Detection compiles the ``residue`` check program alongside
        the chain and arms bounded replay-recovery in
        :meth:`ResidentExecutable.drain`.
        """
        bk = resolve_backend(backend, self.backend)
        if not supports_resident(bk):
            raise ValueError(
                f"backend '{bk.name}' does not support resident "
                f"execution (torch needs pack=true, e.g. "
                f"'torch:pack=true')")
        if detect is None:
            detect = backend_fault_model(bk) is not None
        with obs.span("engine.resident", n=n, rows=rows,
                      backend=bk.name, detect=detect):
            mac_e = self.cache.get_or_compile(
                "multpim_mac", n, config=self.pass_config, verify=verify)
            stage_e = self.cache.get_or_compile(
                "stage", n, config=self.pass_config, verify=verify)
            rec_e = self.cache.get_or_compile(
                "recomb", n, config=self.pass_config, verify=verify)
            res_e = None
            if detect:
                res_e = self.cache.get_or_compile(
                    "residue", n, config=self.pass_config, verify=verify)
        return ResidentExecutable(mac_e, stage_e, rec_e, bk, rows,
                                  crossbar=self.crossbar, engine=self,
                                  residue_entry=res_e)

    def staging_cycles(self, n: int) -> int:
        """Measured cycles of the compiled inter-pass ``stage`` program."""
        return self.cache.get_or_compile(
            "stage", n, config=self.pass_config).program.n_cycles

    def recomb_cycles(self, n: int) -> int:
        """Measured cycles of the compiled ``recomb`` program at width
        ``n`` — the final carry-save merge."""
        return self.cache.get_or_compile(
            "recomb", n, config=self.pass_config).program.n_cycles

    def _adhoc(self, op: str, n: int,
               backend: Union[None, str, Backend] = None) -> Executable:
        """Uncached raw build (benchmark baseline for the cache win)."""
        from repro_torch.compiler.cache import (BUILDERS, CompiledEntry,
                                                _default_builders)
        kind = OP_KINDS.get(op, op)
        builders = dict(_default_builders())
        builders.update(BUILDERS)
        entry = CompiledEntry.adhoc(builders[kind](n))
        return Executable(entry, resolve_backend(backend, self.backend),
                          crossbar=self.crossbar, engine=self)

    def stats(self) -> Dict[str, int]:
        """Shared program-cache counters plus engine run count."""
        st = self.cache.stats()
        st["runs"] = self.runs
        return st

    # ------------------------------------------------------ high level ----
    def multiply(self, a, b, n: int, *, op: str = "multpim",
                 backend: Union[None, str, Backend] = None) -> np.ndarray:
        """Exact ``a * b mod 2^(2n)`` per row on the simulated crossbar."""
        exe = self.compile(op, n, backend=backend)
        return exe.run({"a": np.asarray(a), "b": np.asarray(b)})["out"]

    def mac(self, a, b, s_i, c_i, n: int, *,
            backend: Union[None, str, Backend] = None
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One Section-VI fused MAC: ``s_o + c_o = a*b + s_i + c_i`` in
        carry-save form. Returns ``(lo, s_hi, c_hi)`` integer arrays."""
        exe = self.compile("mac", n, backend=backend)
        return self._mac_on(exe, n, a, b, s_i, c_i)

    def mac_inputs(self, n: int, a, b, s_i, c_i) -> Dict[str, np.ndarray]:
        """Public marshalling helper: one MAC's integer operands
        (``a*b + s_i + c_i`` in carry-save form, per row) -> the bit
        planes a compiled ``mac`` program takes."""
        return self._mac_inputs(n, a, b, s_i, c_i)

    def mac_accumulate(self, n: int, out: Dict[str, np.ndarray]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Public inverse of :meth:`mac_inputs`: a ``mac`` program's
        output bit planes -> the next ``(s, c)`` carry-save accumulator
        state (object-int arrays)."""
        return self._mac_accumulate(n, out)

    def _mac_inputs(self, n: int, a, b, s_i, c_i) -> Dict[str, np.ndarray]:
        """Marshal one MAC's integer operands into the program's bit
        planes (sum/carry latch pre-loads + complemented u-stream).

        Fast path: for n <= 30 all legal values (operands < 2^n,
        accumulators < 2^(2n)) fit int64, so the u-stream/latch
        arithmetic and the bit-plane expansion vectorize end to end;
        wider n (or inputs that overflow int64) take the exact
        object-int path."""
        if n <= 30:
            try:
                a64 = np.asarray(a, dtype=np.int64)
                b64 = np.asarray(b, dtype=np.int64)
                s64 = np.asarray(s_i, dtype=np.int64)
                c64 = np.asarray(c_i, dtype=np.int64)
            except (OverflowError, TypeError, ValueError):
                pass
            else:
                u = (s64 >> n) + (c64 >> n)
                if np.any(u >= np.int64(1) << n):
                    raise OverflowError(
                        "u-stream exceeds N bits (accumulator overflow)")
                m = (np.int64(1) << n) - 1
                c_lo_bits = to_bits(c64 & m, n)
                return {
                    "a": to_bits(a64, n),
                    "b": to_bits(b64, n),
                    "un": 1 - to_bits(u, n),
                    "s_lo": to_bits(s64 & m, n),
                    "c_lo": c_lo_bits,
                    "c_lo_n": 1 - c_lo_bits,
                }
        a = np.asarray(a, dtype=object)
        u = np.array([(int(s) >> n) + (int(c) >> n)
                      for s, c in zip(s_i, c_i)], dtype=object)
        if any(int(x) >= (1 << n) for x in u):
            raise OverflowError(
                "u-stream exceeds N bits (accumulator overflow)")
        c_lo = [int(c) & ((1 << n) - 1) for c in c_i]
        return {
            "a": to_bits(a, n),
            "b": to_bits(b, n),
            "un": 1 - to_bits(u, n),
            "s_lo": to_bits([int(s) & ((1 << n) - 1) for s in s_i], n),
            "c_lo": to_bits(c_lo, n),
            "c_lo_n": 1 - to_bits(c_lo, n),
        }

    @staticmethod
    def _mac_accumulate(n: int, out: Dict[str, np.ndarray]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """MAC outputs -> next (s, c) carry-save accumulator state
        (exact python-int object arrays; int64-vectorized for n <= 30,
        where s, c < 2^(2n) always fit)."""
        if n <= 30:
            w = np.int64(1) << np.arange(n, dtype=np.int64)
            lo = np.asarray(out["lo"], dtype=np.int64) @ w
            s_hi = np.asarray(out["s_hi"], dtype=np.int64) @ w
            c_hi = np.asarray(out["c_hi"], dtype=np.int64) @ w
            s = lo + (s_hi << n)
            c = c_hi << n
            return (np.array(s.tolist(), dtype=object),
                    np.array(c.tolist(), dtype=object))
        lo, s_hi, c_hi = (from_bits(out["lo"]), from_bits(out["s_hi"]),
                          from_bits(out["c_hi"]))
        s = np.array([int(l) + (int(sh) << n)
                      for l, sh in zip(lo, s_hi)], dtype=object)
        c = np.array([int(ch) << n for ch in c_hi], dtype=object)
        return s, c

    def _mac_on(self, exe: Executable, n: int, a, b, s_i, c_i
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        out = exe.run(self._mac_inputs(n, a, b, s_i, c_i))
        return (from_bits(out["lo"]), from_bits(out["s_hi"]),
                from_bits(out["c_hi"]))

    def inner_product(self, a_vec, x_vec, n: int, *,
                      use_compiler: bool = True,
                      backend: Union[None, str, Backend] = None,
                      k: Optional[int] = None,
                      resident: Optional[bool] = None
                      ) -> Tuple[np.ndarray, int]:
        """Full-precision fixed-point inner product per crossbar row.

        ``a_vec``/``x_vec``: (rows, n_elems) unsigned ints. Returns
        (rows,)-int result mod 2^(2n) and the total charged cycle count
        (MAC passes, inter-pass staging and the final recombination, all
        measured compiled cycle counts).

        ``k`` is the co-scheduled MAC group size: the element stream is
        split into ``k`` *independent* carry-save accumulator chains
        (chain ``j`` takes elements ``j, j+k, ...``) whose per-pass MACs
        are co-scheduled into one crossbar via :meth:`compile_batch` —
        ``ceil(E/k)`` crossbar passes instead of ``E``. Default
        (``None``): ``min(coschedule_k, n_elems)`` clamped to the
        crossbar's capacity. ``k=1`` forces the single-chain path, which
        runs **device-resident** (:meth:`resident`) whenever the backend
        supports it: state on the device between passes, host traffic =
        operand planes in + one drain out. ``resident`` overrides that
        policy (``False`` forces the per-pass host round-trip; ``True``
        asserts the resident path is taken). ``use_compiler=False``
        rebuilds the raw program per call and stays sequential and
        round-trip (the paper-parity baseline).
        """
        a_arr = np.asarray(a_vec)
        x_arr = np.asarray(x_vec)
        R, E = a_arr.shape
        if k is None:
            # engine policy, clamped to what the crossbar can hold
            k = (min(self.effective_coschedule_k("mac", n), E)
                 if use_compiler else 1)
        k = max(1, min(int(k), E))
        mask = (1 << (2 * n)) - 1
        bk = resolve_backend(backend, self.backend)

        use_resident = (use_compiler and k == 1 and E >= 1
                        and supports_resident(bk)
                        if resident is None else bool(resident))
        if use_resident:
            if not (use_compiler and k == 1 and E >= 1):
                raise ValueError("resident=True needs use_compiler=True, "
                                 "k=1 and at least one element")
            key = (n, R, bk)
            rex = self._resident_memo.get(key)
            if rex is None:
                rex = self.resident(n, rows=R, backend=bk)
                self._resident_memo[key] = rex
            else:
                rex.reset()
            # Machine-integer columns marshal on to_bits' vectorized path;
            # object (wide) inputs keep its exact path.
            for e in range(E):
                rex.step(a_arr[:, e], x_arr[:, e])
            return rex.drain(), rex.chain_cycles(E)

        a_obj = np.asarray(a_vec, dtype=object)
        x_obj = np.asarray(x_vec, dtype=object)
        if not use_compiler or k == 1:
            exe = (self.compile("mac", n, backend=bk) if use_compiler
                   else self._adhoc("mac", n, backend=bk))
            s = np.zeros(R, dtype=object)
            c = np.zeros(R, dtype=object)
            cycles = 0
            for e in range(E):
                out = exe.run(self._mac_inputs(n, a_obj[:, e], x_obj[:, e],
                                               s, c))
                s, c = self._mac_accumulate(n, out)
                cycles += exe.n_cycles
                if e < E - 1:
                    cycles += self.staging_cycles(n)
            # Final recombination s + c: the compiled in-row merge.
            cycles += self.recomb_cycles(n)
            res = np.array([(int(x) + int(y)) & mask
                            for x, y in zip(s, c)], dtype=object)
            return res, cycles

        # Co-scheduled: k chains, one fused pass per element group.
        bex = self.compile_batch("mac", n, k, backend=bk)
        s = [np.zeros(R, dtype=object) for _ in range(k)]
        c = [np.zeros(R, dtype=object) for _ in range(k)]
        zeros = np.zeros(R, dtype=object)
        passes = -(-E // k)
        cycles = 0
        for p in range(passes):
            group = []
            for j in range(k):
                e = p * k + j
                group.append(self._mac_inputs(
                    n,
                    a_obj[:, e] if e < E else zeros,
                    x_obj[:, e] if e < E else zeros,
                    s[j], c[j]))
            outs = bex.run(group, backend=bk)
            for j in range(k):
                s[j], c[j] = self._mac_accumulate(n, outs[j])
            cycles += bex.n_cycles
            if p < passes - 1:
                cycles += self.staging_cycles(n)
        # Chain merge + final recombination: the k partial (s + c) sums
        # ripple-add pairwise in ceil(log2 k) rounds (chains sit in
        # disjoint column ranges of the same rows, so each round is one
        # in-row 2N-wide compiled merge), plus the usual final s+c
        # recombination — also a 2N-wide merge.
        cycles += self.recomb_cycles(2 * n) * (1 + math.ceil(math.log2(k)))
        res = np.array(
            [sum(int(s[j][r]) + int(c[j][r]) for j in range(k)) & mask
             for r in range(R)], dtype=object)
        return res, cycles

    def matvec(self, A, x, n: int, *, use_compiler: bool = True,
               backend: Union[None, str, Backend] = None,
               k: Optional[int] = None,
               resident: Optional[bool] = None) -> Tuple[np.ndarray, int]:
        """A (m, e) ints, x (e,) ints -> (m,) inner products (each row is
        an independent crossbar row, exactly the paper's Fig. 5 layout;
        ``k`` and ``resident`` as in :meth:`inner_product`)."""
        A = np.asarray(A)
        X = np.broadcast_to(np.asarray(x)[None, :], A.shape)
        return self.inner_product(A, X, n, use_compiler=use_compiler,
                                  backend=backend, k=k, resident=resident)

    @property
    def device(self) -> torch.device:
        """The torch device this engine's backend runs on (``cpu`` for the
        host backends): where its linear layers compute, and where a
        model built on it lives."""
        return torch.device(getattr(self.backend, "device", "cpu"))

    def _linear_device(self, *tensors) -> "list[torch.Tensor]":
        """The layer's operands as tensors on one device, which must be
        this engine's backend device (:attr:`device`): a CUDA engine
        never computes on the host, and a host engine never on the card.
        Host data (numpy, lists) becomes a CPU tensor."""
        want = self.device
        out = [t if isinstance(t, torch.Tensor) or t is None
               else torch.as_tensor(t) for t in tensors]
        for t in out:
            if t is None:
                continue
            if t.device.type != want.type or (
                    want.index is not None and t.device.index != want.index):
                raise ValueError(
                    f"operand on {t.device}, but this engine's backend "
                    f"'{self.backend.name}' runs on {want}: move the "
                    f"operands there (the layer never moves them itself)")
        return out

    def _compile_mac_group(self, n_bits: int) -> None:
        """Compile the co-scheduled K-MAC group the PIM layers are
        accounted on (a plain MAC when co-scheduling is off)."""
        k = self.effective_coschedule_k("mac", n_bits)
        if k >= 2:
            self.compile_batch("mac", n_bits, k)
        else:
            self.compile("mac", n_bits)

    def linear(self, x, w, b=None, *, n_bits: int = 8, mode: str = "pim",
               use_pallas: bool = False, x_group=None, k_group=None):
        """A linear layer under MultPIM fixed-point semantics.

        ``mode``: ``float`` (plain matmul) | ``pim`` (quantize, integer
        matmul bit-identical to the in-memory MultPIM-MAC, dequantize) |
        ``fake`` (quantize-dequantize straight-through for PIM-aware
        finetuning). In ``pim`` mode the Section-VI MAC for ``n_bits`` is
        compiled through this engine's shared cache (the co-scheduled
        K-MAC group), so serving traffic pays schedule compilation once
        per width. ``use_pallas=True`` takes the integer product through
        the bit-serial matmul kernel K3
        (:func:`repro_torch.kernels.bitserial_matmul.bitserial_matmul`)
        in float32, as the reference takes it through its Pallas
        kernel: exact only while ``K (2^n - 1)^2 < 2^24``. Without K3, a
        weight whose scales are its own (no ``k_group``) is quantized
        once and kept while it is unmodified and autograd does not
        record through it (:mod:`repro_torch.pim.quant`), with the same
        bits as quantizing it anew.

        ``x`` (..., in_dim) and ``w`` (in_dim, out_dim) are torch
        tensors on this engine's device (see :meth:`_linear_device`);
        the result is float32 on that device.

        On a mesh of ranks the operands are this rank's shards and the
        scales are the whole tensors' (the reference quantises the
        global arrays): ``x_group`` is the process group over which
        ``x``'s rows are split (the data axes), ``k_group`` the one over
        which ``in_dim`` is split (a row-parallel projection on the
        model axis). ``x``'s amax is the maximum over both, each column
        amax of ``w`` over ``k_group`` (the two in one collective), and
        the product is summed over ``k_group``: in ``pim`` mode the
        integer ``(prod - corr)``, as int64, before it is dequantised.
        The result is then the whole product of this rank's rows.
        """
        from repro_torch.pim.quant import dequantize, qlinear_exact
        x, w, b = self._linear_device(x, w, b)
        if mode == "float":
            y = dist.reduce_from_parallel(x @ w, k_group)
        elif mode in ("fake", "pim"):
            in_dim = x.shape[-1]
            lead = x.shape[:-1]
            x2 = x.reshape(-1, in_dim)
            if mode == "fake":
                xq, wq = _quantized(x2, w, n_bits, 0, x_group, k_group)
                y = dist.reduce_from_parallel(dequantize(xq) @ dequantize(wq),
                                              k_group)
            else:
                with obs.span("pim.linear", bits=n_bits) as sp:
                    if sp:
                        sp.set(rows=x2.shape[0], k=in_dim, n=w.shape[-1])
                    # The schedule accounted in-memory: the co-scheduled
                    # K-MAC group, compiled once per (width, K) through the
                    # shared cache; K is clamped to the crossbar's column
                    # budget.
                    self._compile_mac_group(n_bits)
                    if use_pallas:
                        y = _bitserial_linear(x2, w, n_bits, x_group, k_group)
                    else:
                        y = qlinear_exact(x2, w, n_bits, x_group, k_group)
            y = y.reshape(*lead, w.shape[-1])
        else:
            raise ValueError(mode)
        if b is not None:
            y = y + b
        return y

    def ragged_linear(self, xs, we, counts, *, n_bits: int = 8,
                      mode: str = "pim", x_group=None, k_group=None):
        """MoE dropless per-expert grouped GEMM under MultPIM fixed-point
        semantics: ``xs`` (T, D) expert-sorted rows, ``we`` (E, D, F)
        per-expert weight stack, ``counts`` (E,) ragged segment lengths.

        Same mode contract as :meth:`linear` (``float`` | ``fake`` |
        ``pim``); in ``pim`` mode every expert's GEMM is the quantized
        integer path bit-identical to the in-memory MultPIM-MAC
        (:func:`repro_torch.pim.quant.qragged_matmul_exact`), compiled
        and accounted through this engine's shared co-scheduled MAC
        group exactly like the dense projections. Rows past
        ``sum(counts)`` are zero.

        On a mesh of ranks the scales are the whole tensors', as the
        reference quantises the whole ``(E, D, F)`` stack and every
        routed row: ``x_group`` is the process group over which the
        tokens are split (the data axes), ``k_group`` the one over which
        the experts are (expert parallelism: ``we`` holds this rank's
        experts, ``xs`` the rows routed to them, ``counts`` their
        segments). ``xs``'s amax is the maximum over both, ``we``'s over
        ``k_group`` (the two in one collective,
        :func:`repro_torch.pim.quant.global_amax`).
        Each expert's integer product is then the unsplit one's, bit for
        bit.
        """
        from repro_torch.pim.quant import (dequantize, qragged_linear_exact,
                                           ragged_dot)
        xs, we = self._linear_device(xs, we)
        if mode == "float":
            return ragged_dot(xs, we, counts)
        if mode == "fake":
            xq, wq = _quantized(xs, we, n_bits, None, x_group, k_group)
            return ragged_dot(dequantize(xq), dequantize(wq), counts)
        if mode != "pim":
            raise ValueError(mode)
        with obs.span("pim.ragged_linear", bits=n_bits) as sp:
            if sp:
                sp.set(rows=xs.shape[0], k=we.shape[1], n=we.shape[2],
                       experts=we.shape[0])
            self._compile_mac_group(n_bits)
            return qragged_linear_exact(xs, we, counts, n_bits, x_group,
                                        k_group)


def _quantized(x: torch.Tensor, w: torch.Tensor, n_bits: int, w_axis,
               x_group, k_group):
    """Both operands quantized, each amax over the ranks that split it
    (:func:`repro_torch.pim.quant.global_amax`): ``x`` with one scale,
    ``w`` with one per slice along ``w_axis`` (None: one)."""
    from repro_torch.pim.quant import amax_of, global_amax, quantize
    xa, wa = global_amax(amax_of(x), amax_of(w, w_axis), x_group, k_group)
    return (quantize(x, n_bits, amax=xa),
            quantize(w, n_bits, axis=w_axis, amax=wa))


def _bitserial_linear(x: torch.Tensor, w: torch.Tensor, n_bits: int,
                      x_group, k_group) -> torch.Tensor:
    """The PIM linear's integer product through the bit-serial matmul
    kernel K3 in float32, as the reference takes it through its Pallas
    kernel: exact only while ``K (2^n - 1)^2 < 2^24``."""
    from repro_torch.kernels.bitserial_matmul import bitserial_matmul
    xq, wq = _quantized(x, w, n_bits, 0, x_group, k_group)
    wf = wq.q.to(torch.float32)
    prod = bitserial_matmul(xq.q.contiguous(), wf.contiguous(), n_bits)
    k = x.shape[-1]
    corr = (xq.zero * wf.sum(dim=0, keepdim=True)
            + wq.zero * xq.q.to(torch.float32).sum(dim=-1, keepdim=True)
            - k * xq.zero * wq.zero)
    acc = prod - corr
    if k_group is not None:   # integers below 2^24: exact
        acc = dist.all_reduce(acc.to(torch.int64), k_group
                              ).to(torch.float32)
    return acc * xq.scale * wq.scale


# ------------------------------------------------------ shared default ----
_DEFAULT: Optional[Engine] = None
_DEFAULT_LOCK = threading.Lock()


def get_engine() -> Engine:
    """The process-wide shared Engine, on the default backend: packed
    torch on CUDA. Raises when CUDA is absent — it never falls back to
    the host; build ``Engine("torch:device=cpu")`` to run on the CPU."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Engine()
        return _DEFAULT
