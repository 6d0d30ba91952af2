"""N-bit fixed-point quantization matching the PIM simulator's numerics.

MultPIM operates on unsigned N-bit fixed point. We use symmetric
per-channel affine quantization with an unsigned-offset trick so the
in-memory multiplier sees non-negative operands (the standard deployment
choice for PIM crossbars): ``q = clip(round(x/s) + 2^(n-1), 0, 2^n - 1)``
and matmuls correct the offset analytically.

The port's copy of ``repro.pim.quant``, on torch tensors: every function
computes on the device of its input. The integer products are taken as
float64 matrix products cast to int64 (torch has no int32 matrix product
on CUDA); every partial sum is an integer below ``K (2^n - 1)^2``, so
they are exact while that stays below ``2^53``, which
:func:`qmatmul_exact` checks. CPU and CUDA take the same code path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch import dist

__all__ = ["QTensor", "amax_of", "quantize", "dequantize", "qmatmul_exact",
           "qragged_matmul_exact", "ragged_dot"]


class QTensor(NamedTuple):
    """A quantized tensor: ``q`` int32 in ``[0, 2^n)``, ``scale`` float32
    (per channel or scalar), the width ``n_bits`` and the unsigned offset
    ``zero`` = ``2^(n-1)``."""

    q: torch.Tensor
    scale: torch.Tensor
    n_bits: int
    zero: int


def amax_of(x: torch.Tensor, axis=None) -> torch.Tensor:
    """``|x|``'s maximum: over the whole tensor, or along ``axis`` (kept
    as a dimension of 1), as :func:`quantize` scales by it. An empty
    tensor's whole maximum is 0 (a rank that holds no rows of a split
    tensor adds nothing to the maximum over the ranks)."""
    if axis is None:
        if x.numel() == 0:
            return x.new_zeros(())
        return x.abs().amax()
    return x.abs().amax(dim=axis, keepdim=True)


def quantize(x: torch.Tensor, n_bits: int = 8, axis=None,
             amax: Optional[torch.Tensor] = None) -> QTensor:
    """Symmetric quantization of ``x`` to unsigned ``n_bits`` with the
    offset ``2^(n-1)``: one scale over the whole tensor, or one per slice
    along ``axis`` (``axis=0`` gives a weight one scale per column).
    ``amax`` (:func:`amax_of`'s shape) replaces ``x``'s own: a shard
    takes the whole tensor's, reduced over the ranks that split it."""
    x = torch.as_tensor(x)
    if amax is None:
        amax = amax_of(x, axis)
    scale = torch.clamp_min(amax, 1e-8) / (2 ** (n_bits - 1) - 1)
    zero = 2 ** (n_bits - 1)
    q = torch.clamp(torch.round(x / scale) + zero, 0, 2 ** n_bits - 1)
    return QTensor(q.to(torch.int32), scale.to(torch.float32), n_bits, zero)


def dequantize(t: QTensor) -> torch.Tensor:
    """float32 ``(q - zero) * scale``."""
    return (t.q.to(torch.float32) - t.zero) * t.scale


def _exact_bound(k: int, n_bits: int) -> None:
    if k * (2 ** n_bits - 1) ** 2 >= 2 ** 53:
        raise ValueError(f"K = {k} at {n_bits} bits: the float64 integer "
                         f"product is exact only while K (2^n - 1)^2 < 2^53")


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 product of two non-negative integer tensors, taken
    as a float64 matmul (exact under :func:`_exact_bound`)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def qmatmul_exact(xq: QTensor, wq: QTensor, group=None) -> torch.Tensor:
    """Integer matmul with offset correction; bit-identical to what the
    in-memory MultPIM-MAC mat-vec computes on the quantized operands.
    ``group``: the ranks over which the inner dimension is split (a
    row-parallel projection, each rank's operands one slice of K, both
    quantised with the whole tensors' scales): the integer ``(prod -
    corr)`` is summed over them as int64 before it is dequantised, where
    GSPMD reduces the reference's int32 product, so each rank's result
    is the unsplit one bit for bit.

    (x - zx) sx @ (w - zw) sw = sx sw [xq@wq - zx*sum(wq) - zw*sum(xq)
                                       + K*zx*zw]

    The product and the correction are exact integers (int64 here, int32
    in the reference, which cannot overflow at these widths); only the
    final ``(prod - corr)`` goes through int32 to float32 and the two
    scales, in the reference's order.
    """
    xi = xq.q
    wi = wq.q
    k = xi.shape[-1]
    _exact_bound(k, max(xq.n_bits, wq.n_bits))
    prod = _int_matmul(xi, wi)
    corr = (xq.zero * wi.to(torch.int64).sum(dim=0, keepdim=True)
            + wq.zero * xi.to(torch.int64).sum(dim=-1, keepdim=True)
            - k * xq.zero * wq.zero)
    acc = dist.all_reduce(prod - corr, group)
    return acc.to(torch.int32).to(torch.float32) * xq.scale * wq.scale


def _counts(counts: Union[torch.Tensor, Sequence[int]]) -> list:
    if isinstance(counts, torch.Tensor):
        counts = counts.tolist()
    return [int(c) for c in counts]


def ragged_dot(lhs: torch.Tensor, rhs: torch.Tensor,
               counts: Union[torch.Tensor, Sequence[int]],
               matmul=torch.matmul) -> torch.Tensor:
    """``jax.lax.ragged_dot``: ``lhs`` (T, D) rows sorted by group,
    ``rhs`` (E, D, F), ``counts`` (E,) group sizes -> (T, F), row ``t``
    times its group's ``rhs``. Rows past ``sum(counts)`` are zero.
    ``matmul`` takes each segment's product."""
    cs = _counts(counts)
    if len(cs) != rhs.shape[0]:
        raise ValueError(f"{len(cs)} counts for {rhs.shape[0]} groups")
    if min(cs, default=0) < 0 or sum(cs) > lhs.shape[0]:
        raise ValueError(f"counts {cs} do not fit {lhs.shape[0]} rows")
    parts = []
    lo = 0
    for e, c in enumerate(cs):
        if c:
            parts.append(matmul(lhs[lo:lo + c], rhs[e]))
        lo += c
    dtype = parts[0].dtype if parts else torch.result_type(lhs, rhs)
    tail = lhs.shape[0] - lo
    if tail or not parts:
        parts.append(torch.zeros((tail, rhs.shape[-1]), dtype=dtype,
                                 device=lhs.device))
    return torch.cat(parts, dim=0)


def qragged_matmul_exact(xq: QTensor, wq: QTensor,
                         counts: Union[torch.Tensor, Sequence[int]]
                         ) -> torch.Tensor:
    """Ragged grouped-GEMM variant of :func:`qmatmul_exact` for the MoE
    dropless dispatch: ``xq.q`` is the (T, D) expert-sorted token block,
    ``wq.q`` the (E, D, F) per-expert weight stack (per-tensor scale so
    one offset correction covers every expert), ``counts`` the (E,)
    per-expert segment lengths. Row ``t`` multiplies against its
    segment's expert, with the same analytic zero-point correction, in
    exact integers. Rows past ``sum(counts)`` are zero (the reference
    assumes counts that sum to T).
    """
    xi = xq.q
    wi = wq.q                                          # (E, D, F)
    k = xi.shape[-1]
    _exact_bound(k, max(xq.n_bits, wq.n_bits))
    cs = _counts(counts)
    prod = ragged_dot(xi, wi, cs, matmul=_int_matmul)
    # Per-row sum_d w[expert(row), d, :]: the per-expert column sums
    # expanded along the ragged segments (zero past sum(counts)).
    live = sum(cs)
    wsum = torch.repeat_interleave(
        wi.to(torch.int64).sum(dim=1),
        torch.tensor(cs, dtype=torch.int64, device=wi.device), dim=0)
    wsum = torch.cat([wsum, wsum.new_zeros((xi.shape[0] - live,
                                            wsum.shape[1]))])
    corr = (xq.zero * wsum
            + wq.zero * xi.to(torch.int64).sum(dim=-1, keepdim=True)
            - k * xq.zero * wq.zero)
    y = (prod - corr).to(torch.int32).to(torch.float32) * xq.scale * wq.scale
    if live < y.shape[0]:
        y[live:] = 0
    return y
