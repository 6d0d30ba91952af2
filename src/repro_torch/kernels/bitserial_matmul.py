"""Wrapper of the Hopper bit-serial matmul kernel K3.

``bitserial_matmul(x, w, n_bits)`` computes the float32 (M, N) product
``sum_j 2^j (X_j @ W)`` of the ``n_bits`` low bit planes of the int32
``x`` (M, K) with the float32 ``w`` (K, N) — the integer product the PIM
linear layers take with ``use_pallas=True``. For CUDA tensors it launches
``k3_bitserial_matmul`` from ``csrc/bitserial_matmul.cu`` (built at first
use, :mod:`repro_torch.kernels._build`) on the current stream, without
synchronising, and adds one to ``bitserial_matmul.launches``. For CPU
tensors it runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.bitserial_matmul_ref`) — only because
the tensors lie on the CPU; there is no fallback from the card to the
host.

The kernel runs on the tensor cores in bf16 and stays exact: it cuts
``x & (2^n - 1)`` into ``ceil(n/8)`` 8-bit pieces and ``w`` into three
bf16 pieces by :func:`split_bf16x3`, whose sum is ``w`` exactly; every
bf16 product is exact in float32.

The reference's exactness assertion ``K * 2**n_bits < 2**24`` is kept
as it is. It bounds only ``x``: with integer ``w`` up to ``2^n - 1`` the
float32 sums are exact only while ``K (2^n - 1)^2 < 2^24``, and past
that the result rounds, in the reference as here.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import bitserial_matmul_ref

__all__ = ["bitserial_matmul", "split_bf16x3"]

_HIGH16 = -65536          # int32 0xFFFF0000


def _clear_low16(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` with the low 16 bits of its encoding cleared: the
    bf16 that truncation of ``v`` gives, as a float32."""
    return (v.view(torch.int32) & _HIGH16).view(torch.float32)


def split_bf16x3(w: torch.Tensor) -> "tuple[torch.Tensor, ...]":
    """The kernel's split of float32 ``w`` into three bf16 pieces, each
    returned as float32: ``w0`` is ``w`` with the low 16 bits of its
    encoding cleared (bf16 by truncation), ``w1`` the same of the exact
    remainder ``w - w0``, and ``w2 = w - w0 - w1``, which has at most 8
    significant bits left and so is a bf16 too. ``w0 + w1 + w2 == w``
    exactly wherever ``w2`` stays in the normal range (|w| above about
    1e-30); an integer ``w`` with |w| <= 256 is ``w0`` alone."""
    w = w.to(torch.float32).contiguous()
    w0 = _clear_low16(w)
    r = w - w0
    w1 = _clear_low16(r)
    return w0, w1, r - w1


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bitserial_matmul: need x (M, K) and w (K, N), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int32 or w.dtype != torch.float32:
        raise ValueError(f"bitserial_matmul: need int32 x and float32 w, "
                         f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"bitserial_matmul: x on {x.device}, w on "
                         f"{w.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bitserial_matmul: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("bitserial_matmul: x and w must be contiguous")


def bitserial_matmul(x: torch.Tensor, w: torch.Tensor,
                     n_bits: int = 8) -> torch.Tensor:
    """K3: ``x`` (M, K) int32, ``w`` (K, N) float32 -> float32 (M, N)
    ``sum_j 2^j (X_j @ W)`` over the ``n_bits`` low bit planes of
    ``x``; a new tensor on the device of the inputs."""
    _check(x, w)
    m, k = x.shape
    n = w.shape[1]
    if not (n_bits >= 1 and k * (2 ** n_bits) < 2 ** 24):
        raise AssertionError(f"f32 exactness bound: K * 2**n_bits = "
                             f"{k} * 2**{n_bits} must stay below 2**24")
    if x.device.type == "cpu":
        return bitserial_matmul_ref(x, w, n_bits)
    from ._build import load_library
    lib = load_library()
    with torch.cuda.device(x.device):
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return out
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptr = ctypes.c_void_p
        err = lib.k3_bitserial_matmul(ptr(x.data_ptr()), ptr(w.data_ptr()),
                                      ptr(out.data_ptr()), m, k, n, n_bits,
                                      ptr(stream))
    if err != 0:
        raise RuntimeError(f"k3_bitserial_matmul launch failed: CUDA error "
                           f"{err}")
    bitserial_matmul.launches += 1
    return out


bitserial_matmul.launches = 0
