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

:func:`qlinear_exact` and :func:`qragged_linear_exact` are the engine's
PIM layers from float operands: the same integers as quantizing both and
calling :func:`qmatmul_exact` (:func:`qragged_matmul_exact`), with the
work in phase spans (:mod:`repro_torch.obs`; under ``torch.profiler``
each with the device time of the kernels it launches):

* ``pim.weight`` — every operation whose only input is the weight: its
  amax, :func:`quantize`, its int64 sums over K and (dense) its float64
  levels; ``args.bytes`` is the weight's bytes. On a row-parallel
  projection (``k_group``) its amax joins the activation's in one
  collective and stays in ``pim.activation``. A dense weight whose
  scales are its own keeps its quantization across calls
  (:func:`_kept_weight_side`); on a hit the span holds only the float64
  widening of the kept levels, with ``args`` ``{"bytes": <the levels'
  bytes>, "cached": True}``, and the counters ``pim.weight_cache.hit``
  and ``pim.weight_cache.miss`` count the calls that did and did not
  find it.
* ``pim.activation`` — the activation's amax (with the collective, when
  a group is given), quantize, its int64 row sums and (dense) float64
  levels; ``args.bytes`` is the activation's bytes.
* ``pim.dispatch`` (ragged) — the counts' copy to the host
  (:func:`_counts`, the sync of a ragged call).
* ``pim.product`` — the float64 GEMM and its cast to int64; for a ragged
  call the per-expert loop of :func:`ragged_dot`, whose per-expert
  float64 casts of both operands stay inside it.
* ``pim.dequant`` — ``prod - corr`` (summed over ``k_group``), the int32
  and float32 casts, the scales (ragged: the per-expert sums spread over
  the segments, and the rows past the counts zeroed).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import dist, obs

__all__ = ["QTensor", "amax_of", "global_amax", "quantize", "dequantize",
           "qmatmul_exact", "qragged_matmul_exact", "ragged_dot",
           "qlinear_exact", "qragged_linear_exact"]


class QTensor(NamedTuple):
    """A quantized tensor: ``q`` integer levels in ``[0, 2^n)`` (int32
    from :func:`quantize`; a kept weight's in :func:`_level_dtype`),
    ``scale`` float32 (per channel or scalar), the width ``n_bits`` and
    the unsigned offset ``zero`` = ``2^(n-1)``."""

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


def global_amax(xa: torch.Tensor, wa: Optional[torch.Tensor], x_group,
                k_group):
    """``x``'s amax (a scalar) and ``w``'s amax (its column amax (1, N),
    or a scalar) over the ranks that split them: ``x``'s over
    ``x_group``, then both over ``k_group`` in one collective (``wa``
    None when ``k_group`` is: the weight's own is whole)."""
    xa = dist.max_from_parallel(xa, x_group)
    if k_group is None:
        return xa, wa
    both = dist.max_from_parallel(torch.cat([xa.reshape(1), wa.reshape(-1)]),
                                  k_group)
    return both[0], both[1:].reshape(wa.shape)


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


def _sums(q: torch.Tensor, dim: int) -> torch.Tensor:
    """Integer levels summed along ``dim`` (kept) as int64: a term of the
    offset correction."""
    return q.to(torch.int64).sum(dim=dim, keepdim=True)


def _dequant(xq: QTensor, wq: QTensor, prod: torch.Tensor,
             xsum: torch.Tensor, wsum: torch.Tensor, group) -> torch.Tensor:
    """``prod`` less the offset correction, summed over ``group`` as
    int64, then through int32 to float32 and the two scales."""
    k = xq.q.shape[-1]
    corr = (xq.zero * wsum + wq.zero * xsum - k * xq.zero * wq.zero)
    acc = dist.all_reduce(prod - corr, group)
    return acc.to(torch.int32).to(torch.float32) * xq.scale * wq.scale


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
    _exact_bound(xq.q.shape[-1], max(xq.n_bits, wq.n_bits))
    prod = _int_matmul(xq.q, wq.q)
    return _dequant(xq, wq, prod, _sums(xq.q, -1), _sums(wq.q, 0), group)


def _weight_side(w: torch.Tensor, n_bits: int, amax=None, dense=True,
                 levels: torch.dtype = torch.int32):
    """The ``pim.weight`` phase: ``w`` quantized (one scale per column
    when ``dense``, else one over the stack) with its levels in
    ``levels``, its int64 sums over K and, when ``dense``, its float64
    levels (made after the sums, so the int64 copy is freed first)."""
    with obs.span("pim.weight") as sp:
        if sp:
            sp.set(bytes=w.numel() * w.element_size())
        wq = quantize(w, n_bits, axis=0 if dense else None, amax=amax)
        wsum = _sums(wq.q, -2)
        wq = wq._replace(q=wq.q.to(levels))
        return wq, wsum, (wq.q.to(torch.float64) if dense else None)


# Each dense weight's quantization, kept while its base tensor lives:
# {base: {view key: (version, QTensor, column sums)}} (_kept_weight_side).
_KEPT = WeakIdKeyDictionary()


def _level_dtype(n_bits: int) -> torch.dtype:
    """The narrowest integer dtype that holds ``[0, 2^n)``."""
    if n_bits <= 8:
        return torch.uint8
    return torch.int16 if n_bits <= 15 else torch.int32


def _kept_weight_side(w: torch.Tensor, n_bits: int):
    """:func:`_weight_side` of a dense weight whose column scales are its
    own, quantized once and kept: the levels in :func:`_level_dtype`,
    the int64 column sums and the scales, for every later call on the
    same, unmodified weight, which then only widens the levels to
    float64 (the same bits as a fresh quantization). Kept for the view
    (offset, shape, strides, width, dtype) of its base tensor, as long as
    the base lives, and made anew once the base's version counter moves
    (an in-place torch write anywhere in it; a write that bypasses the
    counter, through ``.data`` or a numpy array sharing the memory, is
    not seen). Not kept while autograd records through ``w``, nor for an
    inference tensor (which has no version)."""
    if (w.requires_grad and torch.is_grad_enabled()) or w.is_inference():
        return _weight_side(w, n_bits)
    base = w if w._base is None else w._base
    key = (w.storage_offset(), tuple(w.shape), w.stride(), n_bits, w.dtype)
    kept = _KEPT.get(base, {}).get(key)
    if kept is not None and kept[0] == w._version:
        obs.counter("pim.weight_cache.hit").inc()
        wq, wsum = kept[1:]
        with obs.span("pim.weight") as sp:
            if sp:
                sp.set(bytes=wq.q.numel() * wq.q.element_size(), cached=True)
            return wq, wsum, wq.q.to(torch.float64)
    obs.counter("pim.weight_cache.miss").inc()
    wq, wsum, wf = _weight_side(w, n_bits, levels=_level_dtype(n_bits))
    _KEPT.setdefault(base, {})[key] = (w._version, wq, wsum)
    return wq, wsum, wf


def qlinear_exact(x: torch.Tensor, w: torch.Tensor, n_bits: int = 8,
                  x_group=None, k_group=None) -> torch.Tensor:
    """``x`` (M, K) float times ``w`` (K, N) float in MultPIM fixed
    point: ``x`` quantized with one scale, ``w`` with one per column,
    each over the ranks that split it (:func:`global_amax`), then
    :func:`qmatmul_exact` of the two over ``k_group``, bit for bit, in
    the phase spans of the module docstring. float32 (M, N)."""
    _exact_bound(x.shape[-1], n_bits)
    wq = None
    if k_group is None:              # the weight's scales are its own
        wq, wsum, wf = _kept_weight_side(w, n_bits)
    with obs.span("pim.activation") as sp:
        if sp:
            sp.set(bytes=x.numel() * x.element_size())
        wa = amax_of(w, 0) if wq is None else None
        xa, wa = global_amax(amax_of(x), wa, x_group, k_group)
        xq = quantize(x, n_bits, amax=xa)
        xsum = _sums(xq.q, -1)
        xf = xq.q.to(torch.float64)
    if wq is None:
        wq, wsum, wf = _weight_side(w, n_bits, wa)
    with obs.span("pim.product"):
        prod = xf @ wf
        del xf, wf                   # freed before the cast, as in _int_matmul
        prod = prod.to(torch.int64)
    with obs.span("pim.dequant"):
        return _dequant(xq, wq, prod, xsum, wsum, k_group)


def _counts(counts: Union[torch.Tensor, Sequence[int]]) -> list:
    """Segment lengths as ints: a tensor's are copied to the host (the
    ``pim.dispatch`` span, one sync)."""
    if isinstance(counts, torch.Tensor):
        with obs.span("pim.dispatch", syncs=1):
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


def _ragged_dequant(xq: QTensor, wq: QTensor, prod: torch.Tensor,
                    xsum: torch.Tensor, wsum: torch.Tensor,
                    cs: list) -> torch.Tensor:
    """:func:`_dequant` of a ragged product: ``wsum`` (E, 1, F) the
    per-expert column sums, spread along the segments ``cs`` (zero past
    ``sum(cs)``); rows past ``sum(cs)`` come out zero."""
    live = sum(cs)
    wsum = torch.repeat_interleave(
        wsum[:, 0], torch.tensor(cs, dtype=torch.int64,
                                 device=wsum.device), dim=0)
    wsum = torch.cat([wsum, wsum.new_zeros((prod.shape[0] - live,
                                            wsum.shape[1]))])
    y = _dequant(xq, wq, prod, xsum, wsum, None)
    if live < y.shape[0]:
        y[live:] = 0
    return y


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
    _exact_bound(xq.q.shape[-1], max(xq.n_bits, wq.n_bits))
    cs = _counts(counts)
    prod = ragged_dot(xq.q, wq.q, cs, matmul=_int_matmul)
    return _ragged_dequant(xq, wq, prod, _sums(xq.q, -1), _sums(wq.q, -2),
                           cs)


def qragged_linear_exact(xs: torch.Tensor, we: torch.Tensor,
                         counts: Union[torch.Tensor, Sequence[int]],
                         n_bits: int = 8, x_group=None, k_group=None
                         ) -> torch.Tensor:
    """:func:`qlinear_exact` for the MoE dispatch: ``xs`` (T, D) float
    expert-sorted rows, ``we`` (E, D, F) float expert stack (one scale
    over the stack), ``counts`` (E,): :func:`qragged_matmul_exact` of
    the two quantized, each scale over the ranks that split it, in the
    phase spans of the module docstring."""
    _exact_bound(xs.shape[-1], n_bits)
    wq = None
    if k_group is None:              # the stack's scale is its own
        wq, wsum, _ = _weight_side(we, n_bits, dense=False)
    with obs.span("pim.activation") as sp:
        if sp:
            sp.set(bytes=xs.numel() * xs.element_size())
        wa = amax_of(we) if wq is None else None
        xa, wa = global_amax(amax_of(xs), wa, x_group, k_group)
        xq = quantize(xs, n_bits, amax=xa)
        xsum = _sums(xq.q, -1)
    if wq is None:
        wq, wsum, _ = _weight_side(we, n_bits, wa, dense=False)
    cs = _counts(counts)
    with obs.span("pim.product"):
        prod = ragged_dot(xq.q, wq.q, cs, matmul=_int_matmul)
    with obs.span("pim.dequant"):
        return _ragged_dequant(xq, wq, prod, xsum, wsum, cs)
