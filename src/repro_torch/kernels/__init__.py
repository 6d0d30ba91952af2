"""The port's crossbar kernels and their plain PyTorch versions.

:func:`crossbar_run_packed` (K1, bit-plane packed) and
:func:`crossbar_run` (K2, unpacked) launch hand-written CUDA kernels for
CUDA tensors and run the plain versions of :mod:`.ref` for CPU tensors.
Importing this package builds nothing: the CUDA library is compiled at
the first launch.
"""
from .crossbar_step import crossbar_run, crossbar_run_packed
from .ref import crossbar_run_ref, crossbar_run_ref_packed

__all__ = ["crossbar_run", "crossbar_run_packed", "crossbar_run_ref",
           "crossbar_run_ref_packed"]
