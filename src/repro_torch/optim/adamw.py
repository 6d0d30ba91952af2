"""AdamW and its learning-rate schedule, as plain functions on tensors.

The port's copy of ``repro.optim.adamw``: the same update on the same
trees (decoupled weight decay on matrices only, bias correction with the
step count as float32, global-norm clipping), not ``torch.optim.AdamW``,
which decays every parameter and keeps its state inside the optimizer.

:func:`adamw_update` updates the parameters, ``m`` and ``v`` **in place**
under ``torch.no_grad()``: the reference donates them to its jitted step
(``donate_argnums``), so XLA writes the new values over the old; a
functional update here would hold a second copy of all three. It still
returns ``(params, OptState, metrics)`` as the reference does, holding
the same tensors.

Sharded (ZeRO-1, :func:`repro_torch.train.make_train_step` over a mesh of
ranks): each rank passes its shards of the gradients, moments and
parameters with ``mesh`` and, for each leaf, the mesh axes it is sharded
over (``axes``). The global norm, and so the clip, is then the whole
tree's: each leaf's sum of squares is summed over exactly the axes that
shard it, so a replicated leaf is counted once. The update itself is
elementwise on the shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import dist
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    """Peak learning rate, moments, epsilon, decay, clip norm and the
    warmup-then-cosine schedule's steps."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    """First and second moments (float32 trees shaped as the parameters)
    and the step count (a 0-d int32 tensor)."""

    m: Any
    v: Any
    count: torch.Tensor


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """step -> learning rate: linear warmup to ``cfg.lr``, then a cosine
    down to ``cfg.min_lr_ratio`` of it at ``cfg.total_steps`` (float32)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
        return cfg.lr * warm * scale
    return lr


def global_norm(tree, mesh=None, axes=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in JAX's order) of each leaf's sum of
    squares, in float32. With ``mesh`` and ``axes`` (one tuple of mesh
    axis names a leaf), the leaves are shards and each sum of squares is
    first summed over its leaf's axes."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    if axes is not None:
        sq = dist.all_reduce_by_axes(sq, axes, mesh, "sum")
    return torch.sqrt(sum(sq))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled so its global norm is at most ``max_norm``, the
    norm before scaling)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: x * scale, tree), norm


def adamw_init(params) -> OptState:
    """Zero moments shaped as ``params`` (float32, on each leaf's device)
    and count 0."""
    zeros = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                     params)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return OptState(m=zeros, v=tree_map(torch.zeros_like, zeros),
                    count=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: OptState, params, *,
                 mesh=None, axes=None) -> Tuple[Any, OptState, dict]:
    """One AdamW step of ``params`` by ``grads``: clip to
    ``cfg.clip_norm``, advance the count, take the scheduled learning
    rate, update the moments and the parameters in place. Returns
    ``(params, OptState(m, v, count + 1), {"grad_norm", "lr"})``, the
    norm taken before clipping. ``mesh``/``axes``: shards, as
    :func:`global_norm` takes them."""
    flat_p, treedef = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state.m)
    flat_v = tree_leaves(state.v)
    if not len(flat_g) == len(flat_m) == len(flat_v) == treedef.num_leaves:
        raise ValueError("grads, moments and params differ in structure")
    gnorm = global_norm(flat_g, mesh, axes)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = state.count + 1
    lr = cosine_schedule(cfg)(count)
    b1, b2 = cfg.b1, cfg.b2
    countf = count.to(torch.float32)
    bc1 = 1 - torch.pow(b1, countf)
    bc2 = 1 - torch.pow(b2, countf)

    # The reference's operations in its order, each rounded on its own
    # (no fused multiply-add), one leaf's temporaries at a time.
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        del g
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        step = (m / bc1).div_(denom)
        del denom
        pf = p.to(torch.float32)
        if p.ndim >= 2:   # decoupled decay on matrices only
            step.add_(pf * cfg.weight_decay)
        step.mul_(lr)
        if pf is p:
            p.sub_(step)
        else:
            p.copy_(pf - step)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.m, state.v, count), metrics
