"""Execution backends: one protocol over the numpy interpreter and torch.

A :class:`Backend` turns a packed program plus an initial crossbar state
``(rows, C)`` of {0,1} into the final state, bit-identically across
implementations. Both stock backends interpret the *same* dense tables
(:class:`~repro_torch.core.executor.PackedProgram`), so a compiled
:class:`~repro_torch.engine.Executable` can hop backends without
recompiling.

Stock registry entries:

* ``"numpy"`` — the pure-numpy host interpreter over the packed tables
  (the reference package's, copied; ``pack=true`` packs 64 rows per
  ``uint64`` word);
* ``"torch"`` — :class:`TorchBackend`: the hand-written Hopper kernels
  of :mod:`repro_torch.kernels.crossbar_step` on a CUDA device, or their
  plain PyTorch versions when ``device="cpu"``. It defaults to
  ``device="cuda"`` and raises when CUDA is absent: it never moves work
  to the host unasked.

``resolve_backend`` accepts a Backend instance, a registered name, or a
``"name:key=val,key=val"`` spec string — e.g.
``"torch:device=cpu,pack=true"`` — so CLI flags map directly onto
backend policy.

Every stock backend also carries a **fault policy** (``faults=<key>``,
e.g. ``"torch:pack=true,faults=flip@1e-5@7"``): the key resolves through
:func:`repro_torch.faults.get_fault_model` to a seeded device-error
model whose transient flips and stuck-at maps are injected as bitwise
masks into the packed executors (:func:`backend_fault_model` is the
single resolution point). ``faults=none`` (or omitting the option)
resolves to no model and leaves every path bit-identical to a
fault-free build. Fault injection requires the packed representation:
torch demands ``pack=true``, and the numpy backend promotes to its
64-bit packed interpreter. Under an active model the torch backend runs
every pass through the plain PyTorch fault-injecting scan
(:func:`repro_torch.kernels.ref.crossbar_run_ref_packed_faulty`), as the
reference runs its jnp scan in place of the Pallas kernel: K1 stays the
fault-free path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Protocol, Union, runtime_checkable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.compiler.macrocycle import DEFAULT_MACRO_FACTOR as DEFAULT_MACRO
from repro_torch.convert import words_to_numpy, words_to_torch
from repro_torch.core.bits import pack_rows, unpack_rows
from repro_torch.core.executor import PackedProgram, gate_eval_packed
from repro_torch.core.isa import Gate
from repro_torch.kernels.crossbar_step import crossbar_run, crossbar_run_packed
from repro_torch.kernels.ref import crossbar_run_ref_packed_faulty

__all__ = ["Backend", "NumpyBackend", "TorchBackend", "ResidentIndex",
           "supports_resident", "register_backend", "resolve_backend",
           "backend_names", "backend_fault_model", "DEFAULT_MACRO"]


def backend_fault_model(backend):
    """The backend's resolved :class:`repro_torch.faults.FaultModel`, or
    ``None`` when faults are inactive — the single place a ``faults=``
    spec becomes behavior. Inactive covers: no ``faults`` field, a
    ``none``/``off`` key, and a model whose every rate is zero (so an
    explicitly-zeroed model still takes the fault-free fast path and
    stays bit-identical)."""
    spec = getattr(backend, "faults", None)
    if spec is None:
        return None
    from repro_torch.faults import get_fault_model
    model = get_fault_model(spec)
    if model is None or not model.active():
        return None
    return model


@runtime_checkable
class Backend(Protocol):
    """Executes packed programs over batched crossbar state."""

    name: str

    def run_state(self, packed: PackedProgram,
                  state: np.ndarray) -> np.ndarray:
        """``state`` (rows, C) {0,1} with C == packed table width; returns
        the final (rows, C) state after all cycles."""
        ...


# ------------------------------------------------------------- resident ----
@dataclass(frozen=True)
class ResidentIndex:
    """Static column wiring of a resident MAC chain (mac/stage/recomb),
    precomputed by :class:`~repro_torch.engine.executable.ResidentExecutable`
    from the three compiled programs' input/output maps. Every transfer
    between programs is a device-side column gather/scatter between
    freshly-zeroed states — no physical column aliasing is assumed, so
    the wiring survives the optimizer's column remapping.
    """

    c_mac: int          # packed table widths (incl. scratch column)
    c_stage: int
    c_rec: int
    ab_cols: np.ndarray      # mac inputs a ++ b       (new operand planes)
    un_cols: np.ndarray      # mac input un            (fresh lanes -> 1)
    slo_cols: np.ndarray     # mac input s_lo          (fresh lanes -> 0)
    cn_cols: np.ndarray      # mac input c_lo_n        (always 1; c_lo = 0
    #                          stays at the zeroed alloc — see staging.py)
    stage_src: np.ndarray    # mac outputs s_hi ++ c_hi ++ lo
    stage_dst: np.ndarray    # stage inputs s_hi ++ c_hi ++ lo
    mac_src: np.ndarray      # stage outputs un ++ s_lo
    mac_dst: np.ndarray      # mac inputs   un ++ s_lo
    rec_dst: np.ndarray      # recomb inputs s_hi ++ c_hi ++ lo
    rec_out: np.ndarray      # recomb output out (2n bits)
    # Optional residue-check wiring (detect mode, repro_torch.faults):
    # the compiled "residue" program reads the same carry-save planes as
    # recomb and emits the 5-bit (mod-3 ++ mod-7) residue pair.
    c_res: int = 0
    res_dst: Optional[np.ndarray] = None  # residue inputs s_hi++c_hi++lo
    res_out: Optional[np.ndarray] = None  # residue outputs r3 ++ r7


class _ChainBase:
    """Shared packing helpers for the resident chains. A chain owns the
    live device state representation for ``rows`` parallel MAC chains
    (rows are the crossbar's SIMD axis — serve slots, matvec rows);
    ``first``/``step`` advance every lane one MAC pass, ``drain`` runs
    the recombination program on a *separate* state and unpacks only its
    ``out`` planes — the single host transfer of a chain's lifetime.
    With a ``residue`` program attached (detect mode), ``residue(dev)``
    likewise runs the mod-3/mod-7 check on a separate state and unpacks
    only its 5 result planes.
    """

    def __init__(self, mac, stage, recomb, idx: ResidentIndex, rows: int,
                 word_bits: Optional[int], residue=None):
        self.mac, self.stage, self.recomb = mac, stage, recomb
        self.res = residue
        self.idx = idx
        self.rows = rows
        self.word_bits = word_bits

    def _pack(self, planes: np.ndarray) -> np.ndarray:
        if self.word_bits is None:
            return np.asarray(planes, dtype=np.uint8)
        return pack_rows(np.asarray(planes, dtype=np.uint8),
                         self.word_bits)

    def _pack_mask(self, mask: np.ndarray) -> np.ndarray:
        """(rows,) bool -> the per-lane broadcast column: (rows, 1) uint8
        lanes unpacked, (W, 1) packed words with one bit per fresh lane."""
        return self._pack(np.asarray(mask, dtype=np.uint8)[:, None])

    def merge_lanes(self, new, old, lanes: np.ndarray):
        """Chain state with ``new``'s cells on ``lanes`` ((rows,) bool)
        and ``old``'s everywhere else — detect mode's row-selected
        replay."""
        keep = self._pack_mask(lanes)
        if self.word_bits is None:
            return np.where(keep.astype(bool), new, old)
        return (new & keep) | (old & ~keep)


class _NumpyChain(_ChainBase):
    """Eager numpy resident chain (unpacked uint8 or 64-wide packed).

    An active fault model promotes the chain to the 64-bit packed
    representation regardless of ``pack`` (fault masks are packed
    words) and routes every program pass through the fault-injecting
    kernel."""

    def __init__(self, backend: "NumpyBackend", mac, stage, recomb,
                 idx: ResidentIndex, rows: int, residue=None):
        self.model = backend_fault_model(backend)
        packed_words = backend.pack or self.model is not None
        super().__init__(mac, stage, recomb, idx, rows,
                         64 if packed_words else None, residue=residue)
        self.backend = backend
        if packed_words:
            self._w = -(-rows // 64)
            self._full = ~np.uint64(0)
            self._dt = np.uint64
        else:
            self._w = rows
            self._full = np.uint8(1)
            self._dt = np.uint8

    def _zeros(self, c: int) -> np.ndarray:
        return np.zeros((self._w, c), dtype=self._dt)

    def _run(self, packed: PackedProgram, st: np.ndarray) -> np.ndarray:
        with obs.span("backend.kernel", backend=self.backend.name,
                      rows=self.rows, cycles=packed.n_cycles,
                      faulty=self.model is not None):
            if self.model is not None:
                from repro_torch.faults.inject import (
                    numpy_kernel_packed_faulty, pass_fault_tensors)
                flips, sa0, sa1 = pass_fault_tensors(
                    self.model, packed, self.rows, 64)
                return numpy_kernel_packed_faulty(packed, st, flips,
                                                  sa0, sa1)
            if self.word_bits is None:
                return NumpyBackend._kernel_unpacked(packed, st)
            return NumpyBackend._kernel_packed(packed, st)

    def first(self, planes: np.ndarray) -> np.ndarray:
        """First MAC pass: every lane starts from zero."""
        idx = self.idx
        st = self._zeros(idx.c_mac)
        st[:, idx.un_cols] = self._full
        st[:, idx.cn_cols] = self._full
        st[:, idx.ab_cols] = self._pack(planes)
        return self._run(self.mac, st)

    def step(self, dev: np.ndarray, planes: np.ndarray,
             fresh: np.ndarray) -> np.ndarray:
        """Restage the live state, then run the next MAC pass."""
        idx = self.idx
        sst = self._zeros(idx.c_stage)
        sst[:, idx.stage_dst] = dev[:, idx.stage_src]
        sst = self._run(self.stage, sst)
        st = self._zeros(idx.c_mac)
        st[:, idx.mac_dst] = sst[:, idx.mac_src]
        st[:, idx.cn_cols] = self._full
        if fresh.any():
            fw = self._pack_mask(fresh)
            st[:, idx.un_cols] |= fw
            st[:, idx.slo_cols] &= ~fw if self.word_bits else 1 - fw
        st[:, idx.ab_cols] = self._pack(planes)
        return self._run(self.mac, st)

    def drain(self, dev: np.ndarray) -> np.ndarray:
        """Recombine into a separate state; ``(rows, 2n)`` out planes."""
        idx = self.idx
        rst = self._zeros(idx.c_rec)
        rst[:, idx.rec_dst] = dev[:, idx.stage_src]
        rst = self._run(self.recomb, rst)
        return self._read(rst[:, idx.rec_out])

    def residue(self, dev: np.ndarray) -> np.ndarray:
        """Run the residue program on a separate state; ``(rows, 5)``
        residue planes."""
        idx = self.idx
        rst = self._zeros(idx.c_res)
        rst[:, idx.res_dst] = dev[:, idx.stage_src]
        rst = self._run(self.res, rst)
        return self._read(rst[:, idx.res_out])

    def _read(self, out: np.ndarray) -> np.ndarray:
        if self.word_bits is None:
            return out
        with obs.span("backend.unpack", backend=self.backend.name,
                      rows=self.rows):
            return unpack_rows(np.ascontiguousarray(out), self.rows)


# ---------------------------------------------------------------- numpy ----
@dataclass(frozen=True)
class NumpyBackend:
    """Reference interpreter over the packed tables, on the host.

    ``pack=True`` switches to the bit-plane packed interpreter: 64
    crossbar rows per ``uint64`` word, word-wide bitwise gate
    evaluation, ``np.bitwise_and.at`` AND-scatter.

    ``faults=<key>`` activates a device-error model (see
    :func:`backend_fault_model`); fault masks are packed words, so an
    active model always runs the 64-bit packed fault-injecting
    interpreter, even with ``pack=False``.
    """

    pack: bool = False
    faults: Optional[str] = None
    name: str = "numpy"

    def run_state(self, packed: PackedProgram, state: np.ndarray) -> np.ndarray:
        """Interpret the packed tables over ``state`` (rows, C) {0,1}."""
        model = backend_fault_model(self)
        if model is not None:
            return self._run_packed_faulty(packed, state, model)
        if self.pack:
            return self._run_packed(packed, state)
        with obs.span("backend.kernel", backend=self.name,
                      rows=state.shape[0], cycles=packed.n_cycles):
            return self._run_unpacked(packed, state)

    def _run_packed_faulty(self, packed: PackedProgram, state: np.ndarray,
                           model) -> np.ndarray:
        from repro_torch.faults.inject import (numpy_kernel_packed_faulty,
                                               pass_fault_tensors)
        state = np.asarray(state, dtype=np.uint8)
        rows = state.shape[0]
        with obs.span("backend.pack", backend=self.name, rows=rows):
            st = pack_rows(state, 64)
        flips, sa0, sa1 = pass_fault_tensors(model, packed, rows, 64)
        with obs.span("backend.kernel", backend=self.name, rows=rows,
                      cycles=packed.n_cycles, faulty=True):
            st = numpy_kernel_packed_faulty(packed, st, flips, sa0, sa1)
        with obs.span("backend.unpack", backend=self.name, rows=rows):
            return unpack_rows(st, rows)

    def _run_unpacked(self, packed: PackedProgram,
                      state: np.ndarray) -> np.ndarray:
        st = np.asarray(state, dtype=np.uint8).copy()
        return self._kernel_unpacked(packed, st)

    @staticmethod
    def _kernel_unpacked(packed: PackedProgram,
                         st: np.ndarray) -> np.ndarray:
        """The interpreter loop alone — ``st`` (rows, C) uint8 is mutated
        in place and returned."""
        gate_id, in_cols = packed.gate_id, packed.in_cols
        out_col = packed.out_col
        for t in range(packed.n_cycles):
            imask = packed.init_mask[t]
            if imask.any():
                st[:, imask] = 1
                continue
            # Gather all inputs first (ops within a cycle are simultaneous).
            gid, ics, ocs = gate_id[t], in_cols[t], out_col[t]
            x0 = st[:, ics[:, 0]].astype(np.int32)
            x1 = st[:, ics[:, 1]].astype(np.int32)
            x2 = st[:, ics[:, 2]].astype(np.int32)
            s3 = x0 + x1 + x2
            res = np.select(
                [gid == int(Gate.NOT), gid == int(Gate.NOR),
                 gid == int(Gate.MIN3), gid == int(Gate.NAND),
                 gid == int(Gate.OR), gid == int(Gate.COPY)],
                [1 - x0, (x0 + x1 == 0).astype(np.int32),
                 (s3 <= 1).astype(np.int32), 1 - x0 * x1,
                 (x0 + x1 >= 1).astype(np.int32), x0],
                default=np.int32(1),
            ).astype(np.uint8)
            # AND-write; the validator guarantees distinct real outputs,
            # duplicates only target the side-effect-free scratch column.
            np.minimum.at(st, (slice(None), ocs), res)
        return st

    def _run_packed(self, packed: PackedProgram,
                    state: np.ndarray) -> np.ndarray:
        state = np.asarray(state, dtype=np.uint8)
        rows = state.shape[0]
        with obs.span("backend.pack", backend=self.name, rows=rows):
            st = pack_rows(state, 64)
        with obs.span("backend.kernel", backend=self.name, rows=rows,
                      cycles=packed.n_cycles):
            st = self._kernel_packed(packed, st)
        with obs.span("backend.unpack", backend=self.name, rows=rows):
            return unpack_rows(st, rows)

    @staticmethod
    def _kernel_packed(packed: PackedProgram, st: np.ndarray) -> np.ndarray:
        """The packed interpreter loop alone — ``st`` (W, C) uint64 words
        are mutated in place and returned."""
        full = ~np.uint64(0)
        gate_id, in_cols, out_col = (packed.gate_id, packed.in_cols,
                                     packed.out_col)
        for t in range(packed.n_cycles):
            imask = packed.init_mask[t]
            if imask.any():
                st[:, imask] = full
                continue
            gid, ics, ocs = gate_id[t], in_cols[t], out_col[t]
            # Gathers before the write: ops in a cycle are simultaneous.
            res = gate_eval_packed(np, gid[None, :], st[:, ics[:, 0]],
                                   st[:, ics[:, 1]], st[:, ics[:, 2]])
            # Exact AND accumulation, duplicate scratch writes included.
            np.bitwise_and.at(st, (slice(None), ocs), res)
        return st

    def resident_chain(self, mac: PackedProgram, stage: PackedProgram,
                       recomb: PackedProgram, idx: ResidentIndex,
                       rows: int, residue: Optional[PackedProgram] = None
                       ) -> _NumpyChain:
        """Build a resident MAC chain over this backend's interpreter."""
        return _NumpyChain(self, mac, stage, recomb, idx, rows,
                           residue=residue)


# ---------------------------------------------------------------- torch ----
def _macro_factor(macro: Optional[int]) -> int:
    """Macro-fusion policy of the packed paths: an explicit ``macro``
    wins, else ``DEFAULT_MACRO``."""
    return max(1, int(macro)) if macro is not None else DEFAULT_MACRO


@dataclass(frozen=True)
class TorchBackend:
    """Crossbar execution through the port's kernels on a torch device.

    ``device`` is where the state lives: ``"cuda"`` (the default) runs
    the hand-written Hopper kernels of
    :mod:`repro_torch.kernels.crossbar_step`; ``"cpu"`` runs their plain
    PyTorch versions, which the CPU tests use. A CUDA device with no
    CUDA available raises at construction.

    ``pack=True`` (the default) packs 32 crossbar rows per int32 word
    and runs K1; ``pack=False`` runs K2 on one uint8 cell per row and
    column. ``macro`` is the macro-cycle fusion depth of the packed
    tables (``None`` = ``DEFAULT_MACRO``; results never depend on it).
    ``row_block`` is the crossbar rows per CUDA block of both kernels
    (``None`` = their default, 1,024 rows), rounded up to 32-row words
    (:attr:`word_block`, at most 32); each kernel halves its words per
    block until its shared memory fits.

    ``faults=<key>`` activates a device-error model (see
    :func:`backend_fault_model`); it requires ``pack=True`` and runs
    every pass through the cycle-at-a-time fault-injecting scan in plain
    PyTorch on the state's device
    (:func:`repro_torch.kernels.ref.crossbar_run_ref_packed_faulty`),
    not K1: injection is a simulation study, and K1 stays the fault-free
    path, as the reference's Pallas kernel does.
    """

    device: str = "cuda"
    pack: bool = True
    macro: Optional[int] = None
    row_block: Optional[int] = None
    faults: Optional[str] = None
    name: str = "torch"

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TorchBackend(device={self.device!r}): CUDA is not "
                f"available; pass device='cpu' to run the plain PyTorch "
                f"versions on the host")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r}")

    @property
    def word_block(self) -> Optional[int]:
        """32-row words per CUDA block of both kernels: ``row_block``
        rounded up to words (``None`` = the kernels' default)."""
        return None if self.row_block is None else max(
            1, -(-self.row_block // 32))

    def _fault_model(self):
        """The active fault model, or ``None``; raises for one without
        ``pack=true`` (fault masks are packed words)."""
        model = backend_fault_model(self)
        if model is not None and not self.pack:
            raise ValueError(
                f"fault injection on the {self.name} backend requires "
                f"pack=true (spec '{self.name}:pack=true,"
                f"faults={self.faults}') — fault masks are packed words")
        return model

    def run_state(self, packed: PackedProgram, state: np.ndarray) -> np.ndarray:
        """Run the program over ``state`` (rows, C) {0,1} on the device."""
        model = self._fault_model()
        state = np.asarray(state, dtype=np.uint8)
        rows = state.shape[0]
        if self.pack:
            with obs.span("backend.pack", backend=self.name, rows=rows):
                words = words_to_torch(pack_rows(state, 32), self.device)
            with obs.span("backend.kernel", backend=self.name, rows=rows,
                          cycles=packed.n_cycles,
                          faulty=model is not None):
                if model is not None:
                    final = crossbar_run_ref_packed_faulty(words, packed,
                                                           model, rows)
                else:
                    final = crossbar_run_packed(
                        words, packed, macro=_macro_factor(self.macro),
                        word_block=self.word_block)
            with obs.span("backend.unpack", backend=self.name, rows=rows):
                return unpack_rows(words_to_numpy(final), rows)
        with obs.span("backend.kernel", backend=self.name, rows=rows,
                      cycles=packed.n_cycles):
            st = torch.from_numpy(np.ascontiguousarray(state)).to(self.device)
            final = crossbar_run(st, packed, word_block=self.word_block)
            return final.cpu().numpy()

    def resident_chain(self, mac: PackedProgram, stage: PackedProgram,
                       recomb: PackedProgram, idx: ResidentIndex,
                       rows: int, residue: Optional[PackedProgram] = None
                       ) -> "_TorchChain":
        """Build a packed device-resident MAC chain (needs pack=true);
        under an active fault model, the fault-injecting chain."""
        if not self.pack:
            raise ValueError("resident execution on the torch backend "
                             "requires pack=true (spec 'torch:pack=true')")
        if self._fault_model() is not None:
            return _FaultyTorchChain(self, mac, stage, recomb, idx, rows,
                                     residue=residue)
        return _TorchChain(self, mac, stage, recomb, idx, rows,
                           residue=residue)


class _TorchChain(_ChainBase):
    """Packed resident chain on a torch device.

    State is a ``(W, C)`` int32 tensor that stays on the device between
    passes. Each program pass is one K1 launch
    (:func:`~repro_torch.kernels.crossbar_step.crossbar_run_packed`):
    ``first`` launches ``mac``, ``step`` launches ``stage`` then
    ``mac``, ``drain`` launches ``recomb``. The column moves between
    launches — the transfers between packed states, the fresh-lane masks
    (``un |= fresh``, ``s_lo &= ~fresh``), ``c_lo_n`` = all-ones and the
    operand scatter — are torch index ops on the device over int64 index
    tensors built once here. The host sends only the packed operand
    planes and the packed fresh word per step, and reads back once per
    drain. In detect mode ``residue`` is one more K1 launch per check.
    """

    def __init__(self, backend: TorchBackend, mac, stage, recomb,
                 idx: ResidentIndex, rows: int, residue=None):
        super().__init__(mac, stage, recomb, idx, rows, 32, residue=residue)
        self.backend = backend
        self.name = backend.name
        self.device = torch.device(backend.device)
        self._w = -(-rows // 32)
        self._macro = _macro_factor(backend.macro)

        def ix(a):
            return torch.as_tensor(np.asarray(a, np.int64),
                                   device=self.device)

        self._ab, self._un = ix(idx.ab_cols), ix(idx.un_cols)
        self._slo, self._cn = ix(idx.slo_cols), ix(idx.cn_cols)
        self._stage_src, self._stage_dst = ix(idx.stage_src), ix(idx.stage_dst)
        self._mac_src, self._mac_dst = ix(idx.mac_src), ix(idx.mac_dst)
        self._rec_dst, self._rec_out = ix(idx.rec_dst), ix(idx.rec_out)
        if residue is not None:
            self._res_dst, self._res_out = ix(idx.res_dst), ix(idx.res_out)

    def _zeros(self, c: int):
        return torch.zeros((self._w, c), dtype=torch.int32,
                           device=self.device)

    def _run(self, packed: PackedProgram, st):
        with obs.span("backend.kernel", backend=self.name, rows=self.rows,
                      cycles=packed.n_cycles):
            return crossbar_run_packed(st, packed, macro=self._macro,
                                       word_block=self.backend.word_block)

    def first(self, planes: np.ndarray):
        """First MAC pass: every lane starts from zero."""
        st = self._zeros(self.idx.c_mac)
        st[:, self._un] = -1
        st[:, self._cn] = -1
        st[:, self._ab] = words_to_torch(self._pack(planes), self.device)
        return self._run(self.mac, st)

    def step(self, dev, planes: np.ndarray, fresh: np.ndarray):
        """Restage the live state (one ``stage`` launch), apply the
        fresh-lane masks and the new operands, then one ``mac`` launch."""
        sst = self._zeros(self.idx.c_stage)
        sst[:, self._stage_dst] = dev[:, self._stage_src]
        sst = self._run(self.stage, sst)
        st = self._zeros(self.idx.c_mac)
        st[:, self._mac_dst] = sst[:, self._mac_src]
        st[:, self._cn] = -1
        fw = words_to_torch(self._pack_mask(fresh), self.device)
        st[:, self._un] = st[:, self._un] | fw
        st[:, self._slo] = st[:, self._slo] & ~fw
        st[:, self._ab] = words_to_torch(self._pack(planes), self.device)
        return self._run(self.mac, st)

    def drain(self, dev) -> np.ndarray:
        """One ``recomb`` launch on a separate state, then the chain's
        single device-to-host read: ``(rows, 2n)`` out planes."""
        rst = self._zeros(self.idx.c_rec)
        rst[:, self._rec_dst] = dev[:, self._stage_src]
        rst = self._run(self.recomb, rst)
        return self._read(rst[:, self._rec_out])

    def residue(self, dev) -> np.ndarray:
        """One ``residue`` launch on a separate state, then a read of its
        ``(rows, 5)`` residue planes."""
        rst = self._zeros(self.idx.c_res)
        rst[:, self._res_dst] = dev[:, self._stage_src]
        rst = self._run(self.res, rst)
        return self._read(rst[:, self._res_out])

    def _read(self, words) -> np.ndarray:
        with obs.span("backend.unpack", backend=self.name, rows=self.rows):
            return unpack_rows(words_to_numpy(words), self.rows)

    def merge_lanes(self, new, old, lanes: np.ndarray):
        """Chain state with ``new``'s cells on ``lanes`` ((rows,) bool)
        and ``old``'s everywhere else, on the device."""
        keep = words_to_torch(self._pack_mask(lanes), self.device)
        return (new & keep) | (old & ~keep)


class _FaultyTorchChain(_TorchChain):
    """Resident chain under an active fault model: every program pass
    runs the cycle-at-a-time fault-injecting scan
    (:func:`repro_torch.kernels.ref.crossbar_run_ref_packed_faulty`) on
    the state's device, drawing that pass's transient flips and the
    epoch's stuck maps from the backend's model — the counterpart of the
    reference's ``_FaultyJaxChain``. The column moves between passes are
    :class:`_TorchChain`'s."""

    def __init__(self, backend: TorchBackend, mac, stage, recomb,
                 idx: ResidentIndex, rows: int, residue=None):
        super().__init__(backend, mac, stage, recomb, idx, rows,
                         residue=residue)
        self.model = backend_fault_model(backend)

    def _run(self, packed: PackedProgram, st):
        with obs.span("backend.kernel", backend=self.name, rows=self.rows,
                      cycles=packed.n_cycles, faulty=True):
            return crossbar_run_ref_packed_faulty(st, packed, self.model,
                                                  self.rows)


def supports_resident(backend) -> bool:
    """Whether ``backend`` can host a resident MAC chain. Stock policy:
    numpy always (packed and unpacked interpreters both have kernel-only
    entry points); torch only packed (the resident representation *is*
    the 32-bit word-packed state). Custom backends opt in by defining
    ``resident_chain``."""
    if getattr(backend, "resident_chain", None) is None:
        return False
    if isinstance(backend, TorchBackend):
        return bool(backend.pack)
    return True


# -------------------------------------------------------------- registry ----
_REGISTRY: Dict[str, Callable[..., Backend]] = {
    "numpy": NumpyBackend,
    "torch": TorchBackend,
}


def register_backend(name: str, factory: Callable[..., Backend]) -> None:
    """Add a backend factory (``factory(**options) -> Backend``)."""
    _REGISTRY[name] = factory


def backend_names() -> list:
    """Registered backend names, sorted."""
    return sorted(_REGISTRY)


def _parse_value(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        return v


def resolve_backend(spec: Union[None, str, Backend],
                    default: Optional[Backend] = None) -> Backend:
    """Backend instance from a name/spec-string/instance (see module
    doc); ``None`` gives ``default``, else a CUDA :class:`TorchBackend`."""
    if spec is None:
        return default if default is not None else TorchBackend()
    if not isinstance(spec, str):
        return spec
    name, _, opts = spec.partition(":")
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend '{name}' "
                       f"(registered: {backend_names()})")
    kwargs = {}
    if opts:
        for item in opts.split(","):
            k, _, v = item.partition("=")
            kwargs[k.strip()] = _parse_value(v.strip())
    try:
        return _REGISTRY[name](**kwargs)
    except TypeError as e:
        raise ValueError(
            f"backend spec '{spec}': {e} — options the '{name}' backend "
            f"accepts are its constructor fields "
            f"(e.g. numpy: pack, faults; torch: device, pack, macro, "
            f"row_block, faults)") from e
