"""Executable: a compiled PIM program bound to a backend.

Produced by :meth:`repro_torch.engine.Engine.compile`; owns the verified,
optimized, packed artifact and knows how to marshal host data in and out
of the crossbar bit planes. ``run`` accepts either pre-marshalled
``(rows, n_bits)`` {0,1} bit planes or plain integer arrays — integer
inputs are converted with :func:`repro_torch.core.bits.to_bits` and,
when *every* input arrived as integers, outputs come back as exact
Python ints via :func:`~repro_torch.core.bits.from_bits`.

:class:`GroupedExecutable` (from :meth:`repro_torch.engine.Engine.
compile_group`) is the co-scheduled variant: K independent operand sets
— possibly of *different* ops (a MAC next to a multiplier next to a
wider MAC) — scatter into disjoint partition/column ranges of one fused
program, one backend pass serves all K, ``cost()`` reports cycles *per
program* instead of per pass, and ``op_costs()`` breaks the fused pass
down into one accounting row per co-scheduled op.
:class:`BatchedExecutable` (:meth:`repro_torch.engine.Engine.
compile_batch`) is its homogeneous special case: K copies of one
verified program. Both run through :meth:`Executable.run`, so on a
packed CUDA backend the fused pass is one K1 launch.

:class:`ResidentExecutable` (from :meth:`repro_torch.engine.Engine.
resident`) keeps ``rows`` carry-save MAC chains on the device between
passes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.bits import from_bits, to_bits
from repro_torch.core.costmodel import CrossbarSpec

from .backends import Backend, ResidentIndex, resolve_backend

__all__ = ["Executable", "GroupedExecutable", "BatchedExecutable",
           "ResidentExecutable", "ExecCost"]


@dataclass(frozen=True)
class ExecCost:
    """Cost-model view of one program invocation (per crossbar pass).

    ``programs`` is the number of programs the pass serves (1 for a
    plain Executable, ``rows`` for a resident chain), so
    ``cycles_per_program`` is the cycles-per-MAC figure. ``row_block``
    reports the backend's explicit row tiling (``None`` = the kernels'
    default). ``pack`` reports the backend's bit-plane packing policy.
    ``energy_proxy`` is the switching-activity estimate — mean memristor
    bit flips per crossbar row for one full pass, from
    :func:`repro_torch.obs.waterfall.switching_activity` — a
    data-independent proxy that, unlike ``energy_uj``'s every-gate-charged
    model, sees actual state transitions (a gate whose output cell
    already holds the computed value switches nothing). A resident chain
    leaves it ``None``, as the reference does.
    """

    cycles: int
    memristors: int
    partitions: int
    latency_us: float
    energy_uj: float
    programs: int = 1
    row_block: Optional[int] = None
    pack: bool = False
    energy_proxy: Optional[float] = None

    @property
    def cycles_per_program(self) -> float:
        """Pass cycles amortized over the programs it serves."""
        return self.cycles / self.programs

    def as_dict(self) -> Dict:
        """Plain-dict form (benchmark/JSON reporting)."""
        d = dict(self.__dict__)
        d["cycles_per_program"] = self.cycles_per_program
        return d


class Executable:
    """One compiled program + backend; compile once, ``run`` many."""

    def __init__(self, entry: "CompiledEntry", backend: Backend,
                 crossbar: CrossbarSpec = CrossbarSpec(),
                 engine: "Optional[Engine]" = None):
        self.entry = entry
        self.backend = backend
        self.crossbar = crossbar
        self.engine = engine          # counts runs in Engine.stats()

    # ---------------------------------------------------------- views ----
    @property
    def spec(self) -> "OpSpec":
        """The :class:`~repro_torch.compiler.spec.OpSpec` identity compiled."""
        return self.entry.key

    @property
    def program(self) -> "Program":
        """The optimized :class:`~repro_torch.core.program.Program`."""
        return self.entry.program

    @property
    def packed(self) -> "PackedProgram":
        """Dense executor tables (shared with the device-table memos)."""
        return self.entry.packed

    @property
    def n_cycles(self) -> int:
        """Modeled crossbar cycles of one pass."""
        return self.entry.program.n_cycles

    @property
    def input_widths(self) -> Dict[str, int]:
        """Bit width of every program input, by name."""
        return {k: len(v) for k, v in self.program.input_map.items()}

    def __repr__(self) -> str:
        return (f"Executable({self.spec}, backend={self.backend.name}, "
                f"{self.n_cycles} cycles)")

    # ----------------------------------------------------------- cost ----
    def cost(self) -> ExecCost:
        """Cycles/area/latency/energy from the Section V cost model."""
        prog = self.program
        gates = sum(len(c.ops) for c in prog.cycles)
        return ExecCost(
            cycles=prog.n_cycles,
            memristors=prog.n_memristors,
            partitions=prog.n_partitions,
            latency_us=prog.n_cycles * self.crossbar.cycle_ns / 1e3,
            energy_uj=gates * self.crossbar.energy_pj_per_gate / 1e6,
            row_block=getattr(self.backend, "row_block", None),
            pack=getattr(self.backend, "pack", False),
            # Memoized on the shared packed tables, so repeated cost()
            # calls (and every Executable over the same cache entry)
            # simulate the switching profile once.
            energy_proxy=obs.switching_activity(self.packed))

    # --------------------------------------------------------- verify ----
    def verify(self) -> "VerifyReport":
        """Differential bit-exactness proof vs the unoptimized build
        (memoized on the cache entry)."""
        if self.entry.verified is None:
            from repro_torch.compiler.verify import verify_or_raise
            self.entry.verified = verify_or_raise(self.entry.raw,
                                                  self.entry.program)
        return self.entry.verified

    # ------------------------------------------------------------ run ----
    def _marshal(self, name: str, value) -> "tuple[np.ndarray, bool]":
        """-> ((rows, n_bits) uint8 planes, was_integer_form)."""
        width = self.input_widths[name]
        arr = np.asarray(value)
        if arr.ndim == 0:
            arr = arr[None]
        if arr.ndim == 1:                       # integer form
            return to_bits(arr, width), True
        if arr.ndim == 2 and arr.shape[1] == width:
            bits = np.asarray(arr, dtype=np.uint8)
            if bits.max(initial=0) > 1:
                raise ValueError(
                    f"input '{name}': 2-D input must be {{0,1}} bit planes "
                    f"(got values > 1); pass a 1-D integer array for "
                    f"automatic marshalling")
            return bits, False
        raise ValueError(
            f"input '{name}': expected (rows,) integers or "
            f"(rows, {width}) bit planes, got shape {arr.shape}")

    def run(self, batch: Mapping[str, Union[np.ndarray, list]], *,
            backend: Union[None, str, Backend] = None
            ) -> Dict[str, np.ndarray]:
        """Execute over a batch of crossbar rows.

        ``batch`` maps every program input name to either ``(rows,)``
        integers or ``(rows, n_bits)`` {0,1} planes. Returns
        ``{output_name: array}`` — exact object ints when all inputs were
        integer-form, bit planes otherwise. ``backend`` overrides the
        bound backend for this call only.
        """
        prog = self.program
        missing = sorted(set(prog.input_map) - set(batch))
        if missing:
            raise KeyError(f"missing program inputs {missing} "
                           f"(required: {sorted(prog.input_map)})")
        with obs.span("exec.run", program=prog.name,
                      backend=self.backend.name,
                      modeled_cycles=prog.n_cycles,
                      modeled_us=prog.n_cycles
                      * self.crossbar.cycle_ns / 1e3) as sp:
            with obs.span("exec.marshal", program=prog.name):
                planes: Dict[str, np.ndarray] = {}
                all_ints = True
                rows = None
                for name in prog.input_map:
                    bits, was_int = self._marshal(name, batch[name])
                    all_ints &= was_int
                    if rows is None:
                        rows = bits.shape[0]
                    elif bits.shape[0] != rows:
                        raise ValueError(
                            f"input '{name}': {bits.shape[0]} rows, but "
                            f"other inputs have {rows}")
                    planes[name] = bits

                state = np.zeros((rows, self.packed.init_mask.shape[1]),
                                 dtype=np.uint8)
                for name, cols in prog.input_map.items():
                    state[:, cols] = planes[name]
            sp.set(rows=rows)

            bk = resolve_backend(backend, default=self.backend)
            # Pack / kernel / unpack break down further inside the
            # backend (``backend.*`` spans).
            final = np.asarray(bk.run_state(self.packed, state))
            if self.engine is not None:
                self.engine.runs += 1

            with obs.span("exec.unmarshal", program=prog.name):
                out: Dict[str, np.ndarray] = {}
                for name, cols in prog.output_map.items():
                    bits = final[:, cols].copy()
                    out[name] = from_bits(bits) if all_ints else bits
                return out


class GroupedExecutable:
    """K co-scheduled programs — not necessarily the same op — served by
    one backend pass.

    Produced by :meth:`repro_torch.engine.Engine.compile_group`. Wraps an
    :class:`Executable` over the fused program
    (:func:`repro_torch.compiler.coschedule.coschedule` of K relocated
    verified programs in disjoint partition/column ranges): ``run``
    scatters K operand sets into the fused input names
    (``g{i}/<name>``, where slot ``i``'s expected names are *its own*
    base program's), executes **one** ``run_state`` call, and gathers K
    result sets back out. ``cost()`` reports ``programs=K``;
    ``op_costs()`` adds one row per co-scheduled slot (label, own
    standalone cycles, column/partition footprint) so heterogeneous
    groups stay auditable op by op.
    """

    def __init__(self, inner: Executable,
                 placements: "List[Placement]",
                 base_entries: "List[CompiledEntry]",
                 labels: Optional[List[str]] = None):
        if len(placements) != len(base_entries):
            raise ValueError("placements/base_entries length mismatch")
        self.inner = inner
        self.placements = placements
        self.base_entries = list(base_entries)
        self.labels = (list(labels) if labels is not None
                       else [str(e.key) for e in base_entries])
        self._in_names = [list(e.program.input_map) for e in base_entries]
        self._out_names = [list(e.program.output_map) for e in base_entries]

    # ---------------------------------------------------------- views ----
    @property
    def k(self) -> int:
        """Number of co-scheduled programs (slots) in the fused pass."""
        return len(self.placements)

    @property
    def program(self) -> "Program":
        """The fused program (all K slots)."""
        return self.inner.program

    @property
    def packed(self) -> "PackedProgram":
        """The fused program's dense executor tables."""
        return self.inner.packed

    @property
    def n_cycles(self) -> int:
        """Cycles of one fused pass (== the longest member's count for
        aligned streams; never more than the sum)."""
        return self.inner.n_cycles

    @property
    def backend(self) -> Backend:
        """The backend the fused pass executes on."""
        return self.inner.backend

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(k={self.k}, "
                f"[{', '.join(dict.fromkeys(self.labels))}], "
                f"backend={self.inner.backend.name}, "
                f"{self.n_cycles} cycles/pass)")

    # ----------------------------------------------------------- cost ----
    def cost(self) -> ExecCost:
        """The fused pass's cost, amortized over its ``k`` programs."""
        one = self.inner.cost()
        return _dc_replace(one, programs=self.k)

    def op_costs(self) -> List[Dict]:
        """Per-op accounting rows for the fused pass: one dict per slot
        with the slot's label, its *standalone* cycle count (what a
        dedicated pass would have cost), and its column/partition
        footprint inside the shared crossbar."""
        rows: List[Dict] = []
        for label, pl, ent in zip(self.labels, self.placements,
                                  self.base_entries):
            rows.append({
                "label": label,
                "op": ent.key.kind,
                "n": ent.key.n,
                "own_cycles": ent.program.n_cycles,
                "fused_cycles": self.n_cycles,
                "cols": pl.n_cols,
                "partitions": pl.n_partitions,
            })
        return rows

    # ------------------------------------------------------------ run ----
    def run(self, batches: Sequence[Mapping[str, Union[np.ndarray, list]]],
            *, backend: Union[None, str, Backend] = None,
            recorder: Optional[object] = None
            ) -> List[Dict[str, np.ndarray]]:
        """Execute K operand sets in one crossbar pass.

        ``batches`` is a length-K sequence; element ``i`` maps slot
        ``i``'s base-program input names to ``(rows,)`` integers or
        ``(rows, n_bits)`` bit planes (all K share the same row count).
        Returns the K output dicts in order, bit-identical to K
        independent :meth:`Executable.run` calls of the member ops.

        ``recorder`` is the device-hierarchy trace hook: any object with
        ``record_pass(gex, batches, results)`` (see
        :class:`repro_torch.device.TraceRecorder`) gets the pass appended
        to its command trace — operands and results included, so the
        trace replays bit-exact. The engine layer stays device-agnostic;
        it only calls back.
        """
        if len(batches) != self.k:
            raise ValueError(f"expected {self.k} operand sets, "
                             f"got {len(batches)}")
        with obs.span("exec.group_run", program=self.program.name,
                      k=self.k, backend=self.inner.backend.name,
                      modeled_cycles=self.n_cycles):
            with obs.span("exec.scatter", k=self.k):
                fused: Dict[str, Union[np.ndarray, list]] = {}
                group_ints: List[bool] = []
                for i, b in enumerate(batches):
                    pfx = self.placements[i].prefix
                    missing = sorted(set(self._in_names[i]) - set(b))
                    if missing:
                        raise KeyError(f"operand set {i}: missing inputs "
                                       f"{missing}")
                    for name in self._in_names[i]:
                        fused[f"{pfx}{name}"] = b[name]
                    # Same integer-vs-bit-plane rule as
                    # Executable._marshal, per group: the fused pass
                    # marshals outputs as ints only when *every* group is
                    # integer-form, so an all-int group mixed with a
                    # bit-plane group is converted back here to stay
                    # bit-identical to K independent runs.
                    group_ints.append(all(np.asarray(b[name]).ndim <= 1
                                          for name in self._in_names[i]))
            out = self.inner.run(fused, backend=backend)
            with obs.span("exec.gather", k=self.k):
                results: List[Dict[str, np.ndarray]] = []
                for i in range(self.k):
                    pfx = self.placements[i].prefix
                    grp = {}
                    for name in self._out_names[i]:
                        val = out[f"{pfx}{name}"]
                        if group_ints[i] and not all(group_ints):
                            val = from_bits(val)
                        grp[name] = val
                    results.append(grp)
            if recorder is not None:
                recorder.record_pass(self, batches, results)
            return results


class BatchedExecutable(GroupedExecutable):
    """K co-scheduled *copies of one op* served by one backend pass —
    the homogeneous special case of :class:`GroupedExecutable`
    (:meth:`repro_torch.engine.Engine.compile_batch`). Its single pass
    has exactly the base program's cycle count, so
    ``cost().cycles_per_program`` is the cycles-per-MAC figure.
    """

    def __init__(self, inner: Executable, k: int,
                 placements: "List[Placement]", base_entry: "CompiledEntry"):
        super().__init__(inner, placements, [base_entry] * k,
                         labels=[base_entry.program.name] * k)
        self.base_entry = base_entry      # the single verified program

    def __repr__(self) -> str:
        return (f"BatchedExecutable(k={self.k}, {self.base_entry.key}, "
                f"backend={self.inner.backend.name}, "
                f"{self.n_cycles} cycles/pass)")


class ResidentExecutable:
    """``rows`` parallel carry-save MAC chains living on device state.

    Produced by :meth:`repro_torch.engine.Engine.resident`. Where the
    round-trip path unmarshals every MAC pass's ``(lo, s_hi, c_hi)``
    planes to host integers, re-derives the next pass's latch pre-loads
    in Python, and re-marshals them back in, a resident executable keeps
    the whole accumulator in crossbar state: the compiled ``stage``
    program (:mod:`repro_torch.core.staging`) restages ``un``/``s_lo``
    in place, so :meth:`step` ships only the *new* operand bit planes
    ``(a, b)`` (plus a one-bit-per-lane fresh mask) and :meth:`drain`
    runs the compiled ``recomb`` program and unpacks its 2N-bit ``out``
    planes exactly once per chain.

    Each crossbar row is an **independent** chain (a serve slot, a
    matvec output row). ``fresh`` lanes restart accumulation at 0 while
    their neighbours keep accumulating. :meth:`drain` is
    non-destructive: it reads the live carry-save pair into a separate
    recombination state.

    Overflow semantics differ from the host path by design: the stage
    ripple wraps the u-stream mod ``2^N`` silently where
    :meth:`Engine.mac_inputs` raises :class:`OverflowError`. Callers
    keep the usual no-overflow precondition (the running inner product
    fits in 2N bits).

    **Detect mode** (``residue_entry`` given — :mod:`repro_torch.faults`):
    every :meth:`step` also feeds a host-side
    :class:`~repro_torch.faults.ResidueShadow` and records the pass
    operands in a bounded replay window; :meth:`drain` then runs the
    compiled ``residue`` program (device-side mod-3/mod-7 check against
    the shadow) plus an exact host-boundary check on the drained token,
    and on detected corruption replays the affected lanes from their
    last restart point — healthy lanes ride along with value-neutral
    ``(0, 0)`` operands, so recovery is pure re-execution with zero
    recompiles. Replay is bounded by ``retry`` (a
    :class:`~repro_torch.faults.RetryPolicy`); lanes still corrupt after
    the last attempt are flagged in :attr:`unrecovered` for the serve
    layer to quarantine (:attr:`ignore` masks quarantined lanes out of
    all checks and persists across :meth:`reset`). Transient faults
    re-draw on every replay pass (the fault model's pass counter is
    monotone), so replay converges; stuck-at faults persist and surface
    as ``unrecovered``.
    """

    def __init__(self, mac_entry: "CompiledEntry",
                 stage_entry: "CompiledEntry",
                 recomb_entry: "CompiledEntry",
                 backend: Backend, rows: int,
                 crossbar: CrossbarSpec = CrossbarSpec(),
                 engine: "Optional[Engine]" = None,
                 residue_entry: "Optional[CompiledEntry]" = None,
                 retry: "Optional[RetryPolicy]" = None):
        if rows < 1:
            raise ValueError("rows >= 1")
        self.mac_entry = mac_entry
        self.stage_entry = stage_entry
        self.recomb_entry = recomb_entry
        self.residue_entry = residue_entry
        self.backend = backend
        self.rows = rows
        self.crossbar = crossbar
        self.engine = engine
        self.n = mac_entry.key.n
        self.index = self._build_index()
        self.chain = backend.resident_chain(
            mac_entry.packed, stage_entry.packed, recomb_entry.packed,
            self.index, rows,
            residue=residue_entry.packed if residue_entry else None)
        self._dev = None
        self.passes = 0
        # --- detect-mode state (all inert when residue_entry is None) --
        self.detect = residue_entry is not None
        self.ignore = np.zeros(rows, dtype=bool)       # quarantined lanes
        self.unrecovered = np.zeros(rows, dtype=bool)  # last drain's losses
        self.replayed_passes = 0
        if self.detect:
            from repro_torch.faults import DEFAULT_POLICY, ResidueShadow
            self.retry = retry or DEFAULT_POLICY
            self.shadow = ResidueShadow(rows, self.n)
            self._history: List = []      # (a, b, fresh) per pass
            self._hist_base = 0           # absolute index of _history[0]
            self._last_fresh = np.zeros(rows, dtype=np.int64)
        else:
            self.retry = retry
            self.shadow = None

    def _build_index(self) -> ResidentIndex:
        mi = self.mac_entry.program.input_map
        mo = self.mac_entry.program.output_map
        si = self.stage_entry.program.input_map
        so = self.stage_entry.program.output_map
        ri = self.recomb_entry.program.input_map
        ro = self.recomb_entry.program.output_map

        def cols(m, *names):
            return np.asarray(sum((list(m[x]) for x in names), []),
                              dtype=np.int64)

        res_kw = {}
        if self.residue_entry is not None:
            qi = self.residue_entry.program.input_map
            qo = self.residue_entry.program.output_map
            res_kw = dict(
                c_res=self.residue_entry.packed.init_mask.shape[1],
                res_dst=cols(qi, "s_hi", "c_hi", "lo"),
                res_out=cols(qo, "r3", "r7"))

        return ResidentIndex(
            c_mac=self.mac_entry.packed.init_mask.shape[1],
            c_stage=self.stage_entry.packed.init_mask.shape[1],
            c_rec=self.recomb_entry.packed.init_mask.shape[1],
            ab_cols=cols(mi, "a", "b"),
            un_cols=cols(mi, "un"),
            slo_cols=cols(mi, "s_lo"),
            cn_cols=cols(mi, "c_lo_n"),
            stage_src=cols(mo, "s_hi", "c_hi", "lo"),
            stage_dst=cols(si, "s_hi", "c_hi", "lo"),
            mac_src=cols(so, "un", "s_lo"),
            mac_dst=cols(mi, "un", "s_lo"),
            rec_dst=cols(ri, "s_hi", "c_hi", "lo"),
            rec_out=cols(ro, "out"),
            **res_kw)

    # ---------------------------------------------------------- views ----
    @property
    def mac_cycles(self) -> int:
        """Cycles of one compiled MAC pass."""
        return self.mac_entry.program.n_cycles

    @property
    def stage_cycles(self) -> int:
        """Cycles of the compiled inter-pass restage program."""
        return self.stage_entry.program.n_cycles

    @property
    def recomb_cycles(self) -> int:
        """Cycles of the compiled final carry-save recombination."""
        return self.recomb_entry.program.n_cycles

    @property
    def pass_cycles(self) -> int:
        """Steady-state cycles per MAC pass: inter-pass restage + MAC."""
        return self.stage_cycles + self.mac_cycles

    def chain_cycles(self, n_passes: int) -> int:
        """Total charged cycles for an ``n_passes``-element chain
        including the final recombination."""
        if n_passes < 1:
            return self.recomb_cycles
        return (n_passes * self.mac_cycles
                + (n_passes - 1) * self.stage_cycles + self.recomb_cycles)

    def __repr__(self) -> str:
        return (f"ResidentExecutable(n={self.n}, rows={self.rows}, "
                f"backend={self.backend.name}, "
                f"{self.pass_cycles} cycles/pass)")

    def cost(self) -> ExecCost:
        """Steady-state per-pass cost; ``programs=rows`` (each crossbar
        row is one MAC chain, so ``cycles_per_program`` is the
        cycles-per-MAC figure)."""
        mac_p = self.mac_entry.program
        stg_p = self.stage_entry.program
        gates = sum(len(c.ops) for c in mac_p.cycles)
        gates += sum(len(c.ops) for c in stg_p.cycles)
        return ExecCost(
            cycles=self.pass_cycles,
            memristors=mac_p.n_memristors + stg_p.n_memristors,
            partitions=max(mac_p.n_partitions, stg_p.n_partitions),
            latency_us=self.pass_cycles * self.crossbar.cycle_ns / 1e3,
            energy_uj=gates * self.crossbar.energy_pj_per_gate / 1e6,
            programs=self.rows,
            pack=getattr(self.backend, "pack", False))

    # ------------------------------------------------------------ run ----
    def _operand_planes(self, a, b) -> np.ndarray:
        n = self.n
        pa = to_bits(np.asarray(a), n)
        pb = to_bits(np.asarray(b), n)
        if pa.shape != (self.rows, n) or pb.shape != (self.rows, n):
            raise ValueError(
                f"expected {self.rows} operand rows, got a: {pa.shape}, "
                f"b: {pb.shape}")
        return np.concatenate([pa, pb], axis=1)

    def step(self, a, b, fresh: Optional[np.ndarray] = None) -> None:
        """Advance every lane one MAC pass: ``acc += a * b`` per row.

        ``a``/``b`` are ``(rows,)`` integers (marshalled to planes here
        — the only host->device traffic of a pass); ``fresh`` is an
        optional ``(rows,)`` bool mask of lanes that restart at 0 this
        pass. The first step implicitly treats every lane as fresh.
        """
        planes = self._operand_planes(a, b)
        if self._dev is None:
            with obs.span("exec.load", backend=self.backend.name,
                          rows=self.rows, n=self.n,
                          modeled_cycles=self.mac_cycles):
                self._dev = self.chain.first(planes)
            fresh_eff = np.ones(self.rows, dtype=bool)
        else:
            if fresh is None:
                fresh = np.zeros(self.rows, dtype=bool)
            else:
                fresh = np.asarray(fresh, dtype=bool)
                if fresh.shape != (self.rows,):
                    raise ValueError(f"fresh mask shape {fresh.shape}, "
                                     f"expected ({self.rows},)")
            with obs.span("exec.step", backend=self.backend.name,
                          rows=self.rows, n=self.n,
                          modeled_cycles=self.pass_cycles):
                self._dev = self.chain.step(self._dev, planes, fresh)
            fresh_eff = fresh
        self.passes += 1
        if self.engine is not None:
            self.engine.runs += 1
        if self.detect:
            self._note_pass(np.asarray(a, dtype=np.int64),
                            np.asarray(b, dtype=np.int64), fresh_eff)

    # -------------------------------------------------- detect/recover ----
    def _note_pass(self, a: np.ndarray, b: np.ndarray,
                   fresh: np.ndarray) -> None:
        """Track one pass for the replay window: update the expected-
        value shadow, append the operands, and advance each lane's last
        restart point. A lane whose expected value is exactly 0 is a
        free restart point (products are non-negative, so value 0 means
        *every* term since the real restart was 0, and a fresh restart
        reproduces it) — this bounds the window for idle lanes."""
        self.shadow.absorb(a, b, fresh)
        self._history.append((a.copy(), b.copy(),
                              np.asarray(fresh, dtype=bool).copy()))
        here = self._hist_base + len(self._history) - 1
        restart = fresh | self.shadow.zero_lanes()
        self._last_fresh = np.where(restart, here, self._last_fresh)
        # Trim history nobody can ever need (quarantined lanes are never
        # replayed, so they don't pin the window).
        live = ~self.ignore
        lo = (int(self._last_fresh[live].min()) if live.any()
              else here + 1)
        drop = lo - self._hist_base
        if drop > 0:
            del self._history[:drop]
            self._hist_base = lo

    def _replay(self, bad: np.ndarray) -> None:
        """Re-execute the ``bad`` lanes' operand history from their last
        restart points, with only those lanes' wordlines selected: the
        crossbar drives the replayed rows and every other row keeps its
        pre-replay cells verbatim (modelled as a lane-masked merge of
        the device words, :meth:`merge_lanes` of the chain). Without the
        row select, transients injected *during* a replay round corrupt
        healthy lanes and recovery random-walks instead of converging.
        No shadow/history updates: the window already describes the
        target state."""
        snap = self._dev          # chain passes never write their input
        start = int(self._last_fresh[bad].min())
        end = self._hist_base + len(self._history)
        with obs.span("exec.replay", backend=self.backend.name,
                      rows=int(bad.sum()), passes=end - start):
            for i in range(start, end):
                a, b, _ = self._history[i - self._hist_base]
                sel = bad & (self._last_fresh <= i)
                ra = np.where(sel, a, 0)
                rb = np.where(sel, b, 0)
                f2 = bad & (self._last_fresh == i)
                planes = self._operand_planes(ra, rb)
                self._dev = self.chain.step(self._dev, planes, f2)
                self.replayed_passes += 1
            self._dev = self.chain.merge_lanes(self._dev, snap, bad)
        obs.counter("faults.replayed_passes").inc(end - start)

    def _drain_once(self) -> np.ndarray:
        with obs.span("exec.drain", backend=self.backend.name,
                      rows=self.rows, n=self.n,
                      modeled_cycles=self.recomb_cycles):
            bits = self.chain.drain(self._dev)
            return from_bits(np.asarray(bits, dtype=np.uint8))

    def _check(self, vals: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
        """``(bad, res_bad)`` lane masks for one drain attempt: the
        device-side residue check plus the exact host-boundary token
        check (the drain crosses to the host anyway; checking there
        models host-side ECC and catches recombination-pass corruption
        the accumulator residue cannot see)."""
        from repro_torch.faults import decode_residues
        active = ~self.ignore
        with obs.span("exec.residue", backend=self.backend.name,
                      rows=self.rows, n=self.n):
            res_bits = np.asarray(self.chain.residue(self._dev),
                                  dtype=np.uint8)
        r3, r7 = decode_residues(res_bits)
        e3, e7 = self.shadow.residues()
        res_bad = ((r3 != e3) | (r7 != e7)) & active
        tok_bad = (np.not_equal(vals, self.shadow.values()).astype(bool)
                   & active)
        return res_bad | tok_bad, res_bad

    def drain(self) -> np.ndarray:
        """Recombine the live carry-save state: ``(rows,)`` exact ints,
        each lane's accumulated ``sum(a_i * b_i) mod 2^(2N)``.
        Non-destructive — lanes keep accumulating afterwards.

        In detect mode each drain is checked (residue program + exact
        host-boundary compare) and corrupted lanes are replayed, up to
        the retry policy's attempt budget; lanes still corrupt at the
        end are flagged in :attr:`unrecovered` (their returned values
        are the corrupt ones — the serve layer decides quarantine)."""
        if self._dev is None:
            raise RuntimeError("no live chain state to drain (call step "
                               "at least once)")
        if not self.detect:
            return self._drain_once()
        ever_bad = np.zeros(self.rows, dtype=bool)
        for attempt in range(self.retry.max_attempts):
            vals = self._drain_once()
            bad, res_bad = self._check(vals)
            if not bad.any():
                if ever_bad.any():
                    obs.counter("faults.recovered").inc(
                        int(ever_bad.sum()))
                self.unrecovered = np.zeros(self.rows, dtype=bool)
                return vals
            obs.counter("faults.detected").inc(int(bad.sum()))
            if res_bad.any():
                obs.counter("faults.detected_residue").inc(
                    int(res_bad.sum()))
            ever_bad |= bad
            if attempt >= self.retry.max_retries:
                break
            self.retry.note_retry(attempt, sleep=False)
            self._replay(bad)
        recovered = ever_bad & ~bad
        if recovered.any():
            obs.counter("faults.recovered").inc(int(recovered.sum()))
        self.unrecovered = bad.copy()
        self.retry.note_exhausted()
        obs.counter("faults.unrecovered").inc(int(bad.sum()))
        obs.instant("faults.drain_unrecovered", rows=int(bad.sum()))
        return vals

    def quarantine(self, lanes: np.ndarray) -> None:
        """Mask ``lanes`` (index array or bool mask) out of all future
        corruption checks and replays — the hook the serve batcher uses
        for persistently-failing slots. Persists across :meth:`reset`."""
        self.ignore[np.asarray(lanes)] = True

    def reset(self) -> None:
        """Forget the live state; the next :meth:`step` starts a fresh
        chain in every lane. Quarantined lanes (:attr:`ignore`) stay
        quarantined — that is device knowledge, not chain state."""
        self._dev = None
        self.passes = 0
        self.unrecovered = np.zeros(self.rows, dtype=bool)
        if self.detect:
            self.shadow.reset()
            self._history = []
            self._hist_base = 0
            self._last_fresh = np.zeros(self.rows, dtype=np.int64)
