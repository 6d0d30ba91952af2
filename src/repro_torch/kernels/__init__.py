"""The port's kernels and their plain PyTorch versions.

:func:`crossbar_run_packed` (K1, bit-plane packed) and
:func:`crossbar_run` (K2, unpacked) run compiled crossbar programs;
:func:`bitserial_matmul` (K3) is the bit-serial matmul of the PIM linear
layers. Each launches a hand-written CUDA kernel for CUDA tensors and
runs its plain version of :mod:`.ref` for CPU tensors. Importing this
package builds nothing: the CUDA library is compiled at the first
launch.
"""
from .bitserial_matmul import bitserial_matmul
from .crossbar_step import crossbar_run, crossbar_run_packed
from .ref import (bitserial_matmul_ref, crossbar_run_ref,
                  crossbar_run_ref_packed)

__all__ = ["crossbar_run", "crossbar_run_packed", "crossbar_run_ref",
           "crossbar_run_ref_packed", "bitserial_matmul",
           "bitserial_matmul_ref"]
