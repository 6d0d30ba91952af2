"""Engine: the device facade — compile once, run many, on a chosen backend.

One Engine fronts the whole pipeline: builders -> pass pipeline ->
differential verify -> packed tables (all via the OpSpec-keyed
:mod:`repro_torch.compiler.cache`) -> a
:class:`~repro_torch.engine.executable.Executable` bound to a
:class:`~repro_torch.engine.backends.Backend`. High-level ops
(``multiply``, ``mac``, ``inner_product``, ``matvec``) are built on that
same compile path, so every caller shares one program cache and one
backend policy.

The default backend is :class:`~repro_torch.engine.backends.TorchBackend`
on CUDA with bit-plane packing: the port runs on the card unless the
caller asks for the CPU (``backend="torch:device=cpu"`` or ``"numpy"``).

Not ported yet, and raising :class:`NotImplementedError` until their
slice lands: co-scheduling (``compile_batch``, ``compile_group`` and
``inner_product``/``matvec`` with ``k > 1`` — the serve slice), drain-time
fault detection (``resident(detect=True)`` — the faults slice) and the
PIM linear layers (``linear``, ``ragged_linear`` — the PIM-linear slice).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.bits import from_bits, to_bits
from repro_torch.core.costmodel import CrossbarSpec

from .backends import Backend, resolve_backend, supports_resident
from .executable import Executable, ResidentExecutable

__all__ = ["Engine", "get_engine", "OP_KINDS"]

# Public op names -> compiler builder kinds.
OP_KINDS: Dict[str, str] = {
    "multpim": "multpim",
    "rime": "rime",
    "hajali": "hajali",
    "mac": "multpim_mac",
    "multpim_mac": "multpim_mac",
    "stage": "stage",
    "recomb": "recomb",
}


def _not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (it comes with the "
        f"{slice_name} slice)")


class Engine:
    """Compile-and-execute front end over the PIM stack.

    ``backend`` is the default execution backend (name, spec string or
    instance — see :func:`repro_torch.engine.backends.resolve_backend`;
    ``None`` = packed torch on CUDA); ``cache`` defaults to the
    process-wide program cache so every Engine shares compiled
    artifacts; ``crossbar`` parameterizes the cost model.
    """

    def __init__(self, backend: Union[None, str, Backend] = None, *,
                 cache: Optional["ProgramCache"] = None,
                 crossbar: CrossbarSpec = CrossbarSpec(),
                 pass_config: Optional["PassConfig"] = None):
        from repro_torch.compiler import cache as _cache_mod
        self.backend = resolve_backend(backend)
        self.cache = cache if cache is not None else _cache_mod._GLOBAL
        self.crossbar = crossbar
        self.pass_config = pass_config
        self.runs = 0
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

        ``op`` is one of ``multpim | rime | hajali | mac | stage |
        recomb`` or any kind registered with
        :func:`repro_torch.compiler.register_builder`.
        """
        kind = OP_KINDS.get(op, op)
        with obs.span("engine.compile", op=kind, n=n):
            entry = self.cache.get_or_compile(
                kind, n, flags=flags, config=config or self.pass_config,
                verify=verify)
        return Executable(entry, resolve_backend(backend, self.backend),
                          crossbar=self.crossbar, engine=self)

    def compile_batch(self, *args, **kwargs):
        """Co-scheduled K-copy compile: not ported yet (serve slice)."""
        raise _not_ported("compile_batch (co-scheduling)", "serve")

    def compile_group(self, *args, **kwargs):
        """Heterogeneous co-scheduled compile: not ported yet (serve
        slice)."""
        raise _not_ported("compile_group (co-scheduling)", "serve")

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
        ``pack=true``). ``detect=True`` (fault detection) is not ported
        yet and raises.
        """
        if detect:
            raise _not_ported("resident(detect=True) (fault detection)",
                              "faults")
        bk = resolve_backend(backend, self.backend)
        if not supports_resident(bk):
            raise ValueError(
                f"backend '{bk.name}' does not support resident "
                f"execution (torch needs pack=true, e.g. "
                f"'torch:pack=true')")
        with obs.span("engine.resident", n=n, rows=rows,
                      backend=bk.name, detect=False):
            mac_e = self.cache.get_or_compile(
                "multpim_mac", n, config=self.pass_config, verify=verify)
            stage_e = self.cache.get_or_compile(
                "stage", n, config=self.pass_config, verify=verify)
            rec_e = self.cache.get_or_compile(
                "recomb", n, config=self.pass_config, verify=verify)
        return ResidentExecutable(mac_e, stage_e, rec_e, bk, rows,
                                  crossbar=self.crossbar, engine=self)

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

        This slice runs one carry-save chain per row (``k`` = 1; ``None``
        means 1 until co-scheduling is ported, and ``k > 1`` raises). The
        chain runs **device-resident** (:meth:`resident`) whenever the
        backend supports it: state on the device between passes, host
        traffic = operand planes in + one drain out. ``resident``
        overrides that policy (``False`` forces the per-pass host
        round-trip; ``True`` asserts the resident path is taken).
        ``use_compiler=False`` rebuilds the raw program per call and
        stays round-trip (the paper-parity baseline).
        """
        a_arr = np.asarray(a_vec)
        x_arr = np.asarray(x_vec)
        R, E = a_arr.shape
        k = 1 if k is None else max(1, min(int(k), E))
        if k > 1:
            raise _not_ported("inner_product/matvec with k > 1 "
                              "(co-scheduled MAC groups)", "serve")
        mask = (1 << (2 * n)) - 1
        bk = resolve_backend(backend, self.backend)

        use_resident = (use_compiler and E >= 1 and supports_resident(bk)
                        if resident is None else bool(resident))
        if use_resident:
            if not (use_compiler and E >= 1):
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

    def linear(self, *args, **kwargs):
        """PIM linear layer: not ported yet (PIM-linear slice, with K3)."""
        raise _not_ported("linear", "PIM-linear")

    def ragged_linear(self, *args, **kwargs):
        """PIM ragged (MoE) linear layer: not ported yet (PIM-linear
        slice, with K3)."""
        raise _not_ported("ragged_linear", "PIM-linear")


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
