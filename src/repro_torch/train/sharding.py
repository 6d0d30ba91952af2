"""Partition rules: logical param/state/batch specs for any mesh.

The port's copy of ``repro.train.sharding``. Rules are written against
the *trailing* dims of each named leaf, so scan-stacked parameters
(leading layer axis) inherit the same rule with the layer axis
unsharded. Any "model"-sharded axis falls back to replication when the
dimension is not divisible by the mesh's model-axis size (e.g. granite's
single KV head, whisper's 51865 vocab) — this keeps one rule table valid
across all ten architectures.

The scheme is standard Megatron-style TP + (pod x data) DP + EP:

* column-parallel in-projections (wq/wk/wv/w1/w3/...), row-parallel
  out-projections (wo/w2);
* experts sharded over "model" (expert parallelism);
* embeddings/LM head sharded over vocab;
* batch over ("pod", "data"); KV caches over batch + kv-heads;
* recurrent states over batch + heads/channels.

A spec is a plain tuple with one entry a dimension: an axis name, a tuple
of axis names, or ``None`` (the reference's ``PartitionSpec``); the
``*_shardings`` functions return a tree of specs shaped as their input
(the reference wraps each in a ``NamedSharding``).

Placement, on a mesh laid over ``torch.distributed`` ranks
(:func:`repro_torch.launch.mesh.make_host_mesh` under a process group):
:func:`shard_leaf`/:func:`shard_tree` slice a whole leaf to this rank's
shard by its spec (``jax.device_put`` with a ``NamedSharding``), and
:func:`gather_leaf`/:func:`gather_tree` take the whole leaf back
(``jax.device_get``). On a mesh without process groups (one process)
both are the identity. :func:`train_state_specs` gives the specs of a
train step's parameters, AdamW state and error-feedback residual.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import dist
from repro_torch.launch.mesh import Mesh, abstract_mesh
from repro_torch.tree import (DictKey, tree_flatten, tree_flatten_with_path,
                               tree_map_with_path)

__all__ = ["param_shardings", "batch_shardings", "state_shardings",
           "zero1_shardings", "logits_sharding", "spec_for_leaf",
           "zero1_spec", "shard_shape", "abstract_mesh", "spec_axes",
           "shard_leaf", "shard_tree", "gather_leaf", "gather_tree",
           "train_state_specs", "is_spec", "spec_leaves"]

Spec = Tuple[Any, ...]

# trailing-dims rules by leaf name
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "final_norm": (None,),
    "pos": (None, None),
    "norm": (None,),
    "patch_proj": (None, "model"),
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    "xq": (None, "model"), "xk": (None, "model"), "xv": (None, "model"),
    "xo": ("model", None),
    "qn": (None,), "kn": (None,),
    "ln1": (None,), "ln2": (None,), "lnx": (None,),
    # mlp
    "w1": (None, "model"), "w3": (None, "model"), "w2": ("model", None),
    # moe
    "router": (None, None),
    "we1": ("model", None, None), "we3": ("model", None, None),
    "we2": ("model", None, None),
    # rglru
    "wx": (None, "model"), "wg": (None, "model"),
    "wa": (None, "model"), "wi": (None, "model"),
    "lam": ("model",), "conv": (None, "model"),
    # rwkv
    "wr": (None, "model"), "wb": (None, "model"),
    "w0": ("model",), "u": ("model",), "gn": ("model",),
    "mix": (None, None), "cmix": (None, None),
    "ck": (None, "model"), "cv": ("model", None), "cr": (None, "model"),
}


def _axis_size(mesh: Mesh, name: Optional[str]) -> int:
    if name is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def spec_for_leaf(mesh: Mesh, name: str, shape: Tuple[int, ...]) -> Spec:
    """The spec of a parameter named ``name`` of ``shape`` (``()``, full
    replication, for a name without a rule)."""
    rule = _RULES.get(name)
    if rule is None:
        return ()
    rule = rule[-len(shape):] if len(shape) <= len(rule) else rule
    pad = len(shape) - len(rule)
    axes = [None] * pad + list(rule)
    out = []
    for dim, ax in zip(shape, axes):
        if ax is not None and ax in mesh.axis_names \
                and dim % _axis_size(mesh, ax) == 0 and dim > 0:
            out.append(ax)
        else:
            out.append(None)
    return tuple(out)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, DictKey):
            return str(entry.key)
    return ""


def param_shardings(mesh: Mesh, params: Any):
    """A spec for each parameter leaf, by its name and shape."""
    return tree_map_with_path(
        lambda path, leaf: spec_for_leaf(mesh, _leaf_name(path),
                                         tuple(leaf.shape)), params)


def _dp(mesh: Mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _dp_size(mesh: Mesh, dp) -> int:
    n = 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        n *= _axis_size(mesh, a)
    return n


def batch_shardings(mesh: Mesh, batch: Any):
    """Each batch leaf's leading axis over the data-parallel axes (full
    replication when the batch does not divide)."""
    dp = _dp(mesh)

    def f(path, leaf):
        shape = tuple(leaf.shape)
        if shape[0] % _dp_size(mesh, dp) == 0:
            return (dp,) + (None,) * (len(shape) - 1)
        return ()
    return tree_map_with_path(f, batch)


def state_shardings(mesh: Mesh, states: Any):
    """Decode-state specs: batch -> dp, heads/channels -> model."""
    dp = _dp(mesh)
    tp = _axis_size(mesh, "model")

    def f(path, leaf):
        shp = tuple(leaf.shape)
        name = _leaf_name(path)
        if len(shp) == 0:                      # cache length scalar
            return ()
        # find batch axis: stacked states have a leading layer axis
        specs = [None] * len(shp)
        b_ax = 0
        # heuristics: (L?, B, T, H, D) KV / (L?, B, nh, hd, hd) wkv /
        # (L?, B, D) vectors / (L?, B, 3, D) conv
        if name in ("k", "v") or (len(shp) >= 4 and name in ("wkv",)):
            b_ax = len(shp) - 4
        elif name in ("h", "tshift", "cshift"):
            b_ax = len(shp) - 2
        elif name == "conv":
            b_ax = len(shp) - 3
        elif name == "enc_out":
            b_ax = 0
        specs[b_ax] = dp
        if name in ("k", "v") and tp > 1:
            if shp[-2] % tp == 0:
                specs[-2] = "model"          # kv heads
            elif shp[-3] % tp == 0:
                # PERF(H1): kv-heads not divisible (GQA kv=8 on tp=16) —
                # shard the *sequence* axis of the cache instead of
                # replicating it across the model axis.
                specs[-3] = "model"
        if name == "wkv" and shp[-3] % tp == 0 and tp > 1:
            specs[-3] = "model"
        if name in ("h", "tshift", "cshift") and shp[-1] % tp == 0 and tp > 1:
            specs[-1] = "model"
        if name == "conv" and shp[-1] % tp == 0 and tp > 1:
            specs[-1] = "model"
        # divisibility guard on batch
        if shp[b_ax] % _dp_size(mesh, dp) != 0:
            specs[b_ax] = None
        return tuple(specs)
    return tree_map_with_path(f, states)


def zero1_spec(mesh: Mesh, name: str, shape: Tuple[int, ...]) -> Spec:
    """ZeRO-1 spec for optimizer state / gradient accumulators: the
    param spec plus the 'data' axis on the largest not-yet-sharded,
    divisible dim."""
    base = spec_for_leaf(mesh, name, shape)
    if "data" not in mesh.axis_names:
        return base
    dsz = mesh.shape["data"]
    axes = list(base) + [None] * (len(shape) - len(base))
    cands = [i for i, (dim, ax) in enumerate(zip(shape, axes))
             if ax is None and dim % dsz == 0 and dim >= dsz]
    if not cands:
        return base
    i = max(cands, key=lambda j: shape[j])
    axes[i] = "data"
    return tuple(axes)


def zero1_shardings(mesh: Mesh, params: Any):
    """A ZeRO-1 spec for each parameter-shaped leaf."""
    return tree_map_with_path(
        lambda path, leaf: zero1_spec(mesh, _leaf_name(path),
                                      tuple(leaf.shape)), params)


def logits_sharding(mesh: Mesh) -> Spec:
    """(batch, sequence, vocab) logits: batch over the data axes."""
    return (_dp(mesh), None, None)


def shard_shape(mesh: Mesh, shape: Tuple[int, ...], spec: Spec
                ) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` array under
    ``spec`` on ``mesh`` (``NamedSharding.shard_shape``): each dimension
    over the product of its axes' sizes. Raises when one does not divide
    (the rules above never give such a spec)."""
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= _axis_size(mesh, a)
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split {n} ways under {spec}")
        out.append(dim // n)
    return tuple(out)


# ------------------------------------------------------------ placement ----
def is_spec(x) -> bool:
    """True for a spec (a plain tuple; not an ``OptState``), the leaf of
    a spec tree."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _dim_axes(spec: Spec, i: int) -> Tuple[str, ...]:
    ax = spec[i] if i < len(spec) else None
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis that ``spec`` shards over, in the spec's order."""
    out = []
    for i in range(len(spec)):
        out.extend(a for a in _dim_axes(spec, i) if a not in out)
    return tuple(out)


def _mesh_order(mesh: Mesh, axes) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in axes)


def shard_leaf(mesh: Mesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's shard of the whole leaf ``x`` under ``spec``: along
    each sharded dimension, the part at this rank's index over that
    dimension's axes (a contiguous copy, so the whole leaf can go). The
    identity on a mesh without process groups."""
    if mesh.comm is None:
        return x
    out = x
    for i in range(x.ndim):
        axes = _dim_axes(spec, i)
        if not axes:
            continue
        if _mesh_order(mesh, axes) != tuple(axes):
            raise ValueError(f"spec {spec} names axes out of the mesh's "
                             f"order {mesh.axis_names}")
        ax = mesh.comm.axis(axes)
        if x.shape[i] % ax.size:
            raise ValueError(f"dimension {i} of {tuple(x.shape)} does not "
                             f"split {ax.size} ways under {spec}")
        n = x.shape[i] // ax.size
        out = out.narrow(i, ax.index * n, n)
    if out is x:
        return x
    return out.detach().clone().requires_grad_(x.requires_grad)


def gather_leaf(mesh: Mesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole leaf of this rank's shard ``x`` under ``spec`` (every
    rank of the mesh calls it, in the same order): an all-gather along
    each sharded dimension over its axes. The identity on a mesh without
    process groups."""
    if mesh.comm is None:
        return x
    out = x.detach()
    for i in range(x.ndim):
        axes = _dim_axes(spec, i)
        if axes:
            out = dist.all_gather(out, mesh.comm.axis(axes).group, dim=i)
    return out


def spec_leaves(specs, n: int) -> list:
    """The specs of a spec tree in JAX's leaf order; raises unless there
    are ``n``."""
    leaves = [s for _, s in tree_flatten_with_path(specs,
                                                   is_leaf=is_spec)[0]]
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} specs for {n} leaves")
    return leaves


def shard_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """:func:`shard_leaf` over a tree and its spec tree."""
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([shard_leaf(mesh, x, s) for x, s in zip(
        leaves, spec_leaves(specs, len(leaves)))])


def gather_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """:func:`gather_leaf` over a tree and its spec tree."""
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([gather_leaf(mesh, x, s) for x, s in zip(
        leaves, spec_leaves(specs, len(leaves)))])


def train_state_specs(mesh: Mesh, params: Any):
    """``(param specs, OptState specs, residual specs)`` of a train step
    over ``mesh`` for whole parameters shaped as ``params``: parameters
    by the rules, AdamW's ``m``/``v`` and the error-feedback residual by
    ZeRO-1 (the reference's ``jit_for``), the step count replicated."""
    from repro_torch.optim.adamw import OptState
    ps = param_shardings(mesh, params)
    zs = zero1_shardings(mesh, params)
    return ps, OptState(m=zs, v=zs, count=()), zs
