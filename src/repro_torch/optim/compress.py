"""Gradient compression: int8 error-feedback quantization.

The port's copy of ``repro.optim.compress``. Gradients are quantized to
int8 with one scale a tensor (``max|g| / 127``, rounding half to even, as
``jnp.round`` does) and the quantization error is carried to the next
step, so it does not bias the long-run update direction. On the same
float32 inputs :func:`quantize_grad`, :func:`dequantize_grad` and
:func:`ef_compress_tree` give the reference's values bit for bit.

:func:`compressed_psum` is the int8-on-the-wire all-reduce: the
reference's ``pmax``/``psum`` over a mesh axis become
``torch.distributed.all_reduce`` (``MAX`` for the scale, ``SUM`` for the
int32 values) over a process group.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves

__all__ = ["quantize_grad", "dequantize_grad", "ef_compress_tree",
           "compressed_psum"]


def quantize_grad(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values in [-127, 127], float32 scale) of ``g``."""
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 ``q * scale``."""
    return q.to(torch.float32) * scale


def ef_compress_tree(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Error-feedback compression over a gradient tree.

    Returns (decompressed grads actually applied, new residual)."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        q, s = quantize_grad(gf)
        deq = dequantize_grad(q, s)
        return deq, gf - deq

    flat_g, treedef = tree_flatten(grads)
    outs = [one(g, r) for g, r in zip(flat_g, tree_leaves(residual))]
    return (treedef.unflatten([o[0] for o in outs]),
            treedef.unflatten([o[1] for o in outs]))


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``g`` over the processes of ``group`` (default: the
    world), int8 on the wire: quantize with the largest scale of any
    process, sum the int32 values, dequantize and divide by the group's
    size. Needs an initialised ``torch.distributed`` process group."""
    import torch.distributed as dist
    _, scale = quantize_grad(g)
    scale = scale.clone()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = torch.tensor(dist.get_world_size(group), dtype=torch.float32,
                     device=g.device)
    return total.to(torch.float32) * scale / n
