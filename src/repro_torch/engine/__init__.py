"""repro_torch.engine — one device/executable API over the PIM stack.

The port's counterpart of ``repro.engine``. An :class:`Engine` fronts
the schedule builders, the optimizing compiler + OpSpec-keyed program
cache, the executors and the cost model; an :class:`Executable` is one
compiled program you run many times on a chosen :class:`Backend`.

Quickstart (on the card; pass ``"torch:device=cpu"`` for the host)::

    from repro_torch.engine import Engine
    eng = Engine("torch:pack=true")
    exe = eng.compile(op="multpim", n=16)
    print(exe.run({"a": [12345], "b": [321]})["out"])   # [3962745]
    print(eng.matvec([[3, 5]], [7, 9], 8, k=1)[0])       # [66]

Backends: ``"torch"`` (:class:`TorchBackend`: the Hopper kernels on
CUDA, their plain PyTorch versions on the CPU) and ``"numpy"`` (the host
interpreter). :func:`get_engine` is the process-wide default Engine on
CUDA.
"""
from .backends import (DEFAULT_MACRO, Backend, NumpyBackend, TorchBackend,
                       backend_names, register_backend, resolve_backend)
from .engine import OP_KINDS, Engine, get_engine
from .executable import ExecCost, Executable, ResidentExecutable

# Re-exported so callers can build specs/cache keys without touching
# repro_torch.compiler directly.
from repro_torch.compiler.spec import OpSpec

__all__ = [
    "Engine", "get_engine", "OP_KINDS", "Executable", "ResidentExecutable",
    "ExecCost", "OpSpec",
    "Backend", "NumpyBackend", "TorchBackend",
    "register_backend", "resolve_backend", "backend_names", "DEFAULT_MACRO",
]
