"""Executable: a compiled PIM program bound to a backend.

Produced by :meth:`repro_torch.engine.Engine.compile`; owns the verified,
optimized, packed artifact and knows how to marshal host data in and out
of the crossbar bit planes. ``run`` accepts either pre-marshalled
``(rows, n_bits)`` {0,1} bit planes or plain integer arrays — integer
inputs are converted with :func:`repro_torch.core.bits.to_bits` and,
when *every* input arrived as integers, outputs come back as exact
Python ints via :func:`~repro_torch.core.bits.from_bits`.

:class:`ResidentExecutable` (from :meth:`repro_torch.engine.Engine.
resident`) keeps ``rows`` carry-save MAC chains on the device between
passes. The co-scheduled ``GroupedExecutable``/``BatchedExecutable`` of
the reference package come with the serve slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.bits import from_bits, to_bits
from repro_torch.core.costmodel import CrossbarSpec

from .backends import Backend, ResidentIndex, resolve_backend

__all__ = ["Executable", "ResidentExecutable", "ExecCost"]


@dataclass(frozen=True)
class ExecCost:
    """Cost-model view of one program invocation (per crossbar pass).

    ``programs`` is the number of programs the pass serves (1 for a
    plain Executable, ``rows`` for a resident chain), so
    ``cycles_per_program`` is the cycles-per-MAC figure. ``row_block``
    reports the backend's explicit row tiling (``None`` = the kernels'
    default). ``pack`` reports the backend's bit-plane packing policy.
    (The reference's ``energy_proxy`` needs its waterfall module, which
    is not ported yet.)
    """

    cycles: int
    memristors: int
    partitions: int
    latency_us: float
    energy_uj: float
    programs: int = 1
    row_block: Optional[int] = None
    pack: bool = False

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
            pack=getattr(self.backend, "pack", False))

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

    Detect mode (the reference package's residue check and replay) is
    not ported yet: :meth:`Engine.resident` raises for ``detect=True``.
    """

    def __init__(self, mac_entry: "CompiledEntry",
                 stage_entry: "CompiledEntry",
                 recomb_entry: "CompiledEntry",
                 backend: Backend, rows: int,
                 crossbar: CrossbarSpec = CrossbarSpec(),
                 engine: "Optional[Engine]" = None):
        if rows < 1:
            raise ValueError("rows >= 1")
        self.mac_entry = mac_entry
        self.stage_entry = stage_entry
        self.recomb_entry = recomb_entry
        self.backend = backend
        self.rows = rows
        self.crossbar = crossbar
        self.engine = engine
        self.n = mac_entry.key.n
        self.index = self._build_index()
        self.chain = backend.resident_chain(
            mac_entry.packed, stage_entry.packed, recomb_entry.packed,
            self.index, rows)
        self._dev = None
        self.passes = 0

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
            rec_out=cols(ro, "out"))

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
        self.passes += 1
        if self.engine is not None:
            self.engine.runs += 1

    def drain(self) -> np.ndarray:
        """Recombine the live carry-save state: ``(rows,)`` exact ints,
        each lane's accumulated ``sum(a_i * b_i) mod 2^(2N)``.
        Non-destructive — lanes keep accumulating afterwards."""
        if self._dev is None:
            raise RuntimeError("no live chain state to drain (call step "
                               "at least once)")
        with obs.span("exec.drain", backend=self.backend.name,
                      rows=self.rows, n=self.n,
                      modeled_cycles=self.recomb_cycles):
            bits = self.chain.drain(self._dev)
            return from_bits(np.asarray(bits, dtype=np.uint8))

    def reset(self) -> None:
        """Forget the live state; the next :meth:`step` starts a fresh
        chain in every lane."""
        self._dev = None
        self.passes = 0
