"""Gradient compression: int8 error-feedback quantization.

The port's copy of ``repro.optim.compress``. Gradients are quantized to
int8 with one scale a tensor (``max|g| / 127``, rounding half to even, as
``jnp.round`` does) and the quantization error is carried to the next
step, so it does not bias the long-run update direction. On the same
float32 inputs :func:`quantize_grad`, :func:`dequantize_grad` and
:func:`ef_compress_tree` give the reference's values bit for bit.

On sharded gradients and residuals (ZeRO-1), :func:`ef_compress_tree`
takes each leaf's scale over the whole leaf: the largest magnitude of its
shards, over the mesh axes that shard it.

:func:`compressed_psum` is the int8-on-the-wire all-reduce: the
reference's ``pmax``/``psum`` over a mesh axis become all-reduces
(``MAX`` for the scale, ``SUM`` for the int32 values) over a process
group (:mod:`repro_torch.dist`).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import dist
from repro_torch.tree import tree_flatten, tree_leaves

__all__ = ["quantize_grad", "dequantize_grad", "ef_compress_tree",
           "compressed_psum"]


def quantize_grad(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values in [-127, 127], float32 scale) of ``g``."""
    return _quantize(g, torch.amax(torch.abs(g)))


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 ``q * scale``."""
    return q.to(torch.float32) * scale


def _quantize(g: torch.Tensor, amax: torch.Tensor):
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress_tree(grads: Any, residual: Any, *, mesh=None,
                     axes=None) -> Tuple[Any, Any]:
    """Error-feedback compression over a gradient tree.

    Returns (decompressed grads actually applied, new residual). With
    ``mesh`` and ``axes`` (one tuple of mesh axis names a leaf) the
    leaves are shards, and each scale is its whole leaf's."""
    flat_g, treedef = tree_flatten(grads)
    gf = [g.to(torch.float32) + r
          for g, r in zip(flat_g, tree_leaves(residual))]
    amax = [torch.amax(torch.abs(x)) for x in gf]
    if axes is not None:
        amax = dist.all_reduce_by_axes(amax, axes, mesh, "max")
    outs = []
    for x, a in zip(gf, amax):
        deq = dequantize_grad(*_quantize(x, a))
        outs.append((deq, x - deq))
    return (treedef.unflatten([o[0] for o in outs]),
            treedef.unflatten([o[1] for o in outs]))


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``g`` over the processes of ``group`` (default: the
    world), int8 on the wire: quantize with the largest scale of any
    process, sum the int32 values, dequantize and divide by the group's
    size. Needs an initialised ``torch.distributed`` process group."""
    import torch.distributed as tdist
    if group is None:
        group = tdist.group.WORLD
    _, scale = quantize_grad(g)
    scale = dist.all_reduce_max(scale, group)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = dist.all_reduce(q.to(torch.int32), group)
    n = torch.tensor(tdist.get_world_size(group), dtype=torch.float32,
                     device=g.device)
    return total.to(torch.float32) * scale / n
