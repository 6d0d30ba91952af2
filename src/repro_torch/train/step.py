"""Train-step, serve-step and prefill factories (the port's copy of
``repro.train.step``).

The reference jits each step with explicit shardings over its mesh and
donates its buffers. The port's ``jit_for`` returns the step itself (no
``torch.compile``); the optimizer updates the parameters and moments in
place and the decode states update in place
(:func:`repro_torch.models.transformer.decode_step`), which is what the
reference's donation buys. Over a mesh of ``torch.distributed`` ranks
the train step is sharded as the reference's shardings say: tensor
parallel over ``model`` (the blocks' layout), data parallel over
``pod``/``data`` with ZeRO-1 (see :func:`make_train_step`; one process
is the mesh of one device); serving and prefill stay unsharded.

``make_train_step``: a microbatched (gradient-accumulation) AdamW step.
Forward and backward run one microbatch at a time, so only one
microbatch's activations are ever live (the reference's ``value_and_grad``
inside its ``lax.scan``); with a model built with ``remat=True`` each
stacked unit is also rematerialised in backward.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch import dist
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.model import Model, abstract_params
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update
from repro_torch.optim.compress import ef_compress_tree
from repro_torch.tree import tree_flatten, tree_leaves

from .sharding import (shard_leaf, shard_shape, spec_axes, spec_leaves,
                       train_state_specs)

__all__ = ["make_train_step", "make_serve_step", "make_prefill"]


def make_train_step(model: Model, opt_cfg: AdamWConfig, mesh=None, *,
                    microbatches: int = 1, compress_grads: bool = False):
    """Returns ``(train_step, init_fn, jit_for)``, over ``mesh``: a
    :class:`repro_torch.launch.mesh.Mesh` over ``torch.distributed``
    ranks (``make_host_mesh`` under a process group), or None or a mesh
    of one device without process groups (one process, where every
    collective below is the identity). The reference's ``jit_for`` made
    explicit:

    * ``init_fn(seed=0, dtype=float32) -> (params, opt_state,
      residual)``: the whole model from ``seed`` (so a run's numbers do
      not depend on the mesh), each leaf sliced to this rank's shard by
      its spec and ``requires_grad_``; AdamW's float32 ``m``/``v`` and,
      under ``compress_grads``, the error-feedback residual, zero and
      placed by ZeRO-1 (``zero1_spec``: the parameter's spec plus
      ``data`` on its largest unsharded dimension that divides), else
      None.
    * ``train_step(params, opt_state, residual, batch) -> (params,
      opt_state, residual, metrics)``: every rank passes the whole global
      batch. Its leading axis splits into ``microbatches`` equal parts,
      and each data rank (row-major over ``pod``, ``data``) takes its
      rows of each, as the reference's ``to_mb`` lays them out: rows
      ``[i B/mb + d B/(mb dp), ...)`` of microbatch ``i``. Each part's
      loss and gradients (``torch.autograd.grad``; this rank's shards,
      over the model axis by the blocks' layout) are taken in turn. Each
      gradient is reduce-scattered over ``data`` into the ZeRO-1 float32
      accumulator one leaf at a time, and freed (a leaf where no
      dimension divides is all-reduced and kept whole; ``pod`` is
      all-reduced); the sums are scaled by ``1 / microbatches``.
      Gradients are float32 when they are summed over microbatches or
      over data ranks, else in the parameters' dtype. Then int8 error
      feedback (``compress_grads``, each leaf's whole scale) and AdamW
      on this rank's ZeRO-1 slice of each parameter with the whole
      tree's norm, in place; the updated slices are all-gathered back
      over ``data``. ``metrics``: ``loss`` (the global masked mean, each
      rank's share summed over the data ranks,
      :mod:`repro_torch.models.model`), ``grad_norm`` and ``lr``, 0-d
      tensors on the model's device.
    * ``jit_for(params, batch)`` returns ``train_step``.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if mesh is None:
        mesh = abstract_mesh((1, 1), ("data", "model"))
    elif mesh.comm is None and mesh.size > 1:
        raise ValueError(f"a mesh of {mesh.size} devices without process "
                         f"groups: run one process a rank under "
                         f"torch.distributed (make_host_mesh)")
    plan = _leaf_plan(mesh, abstract_params(model.cfg))
    axes = [leaf.axes for leaf in plan]
    dp = dist.mesh_axis(mesh, ("pod", "data"))
    data = dist.mesh_axis(mesh, ("data",))
    pod = dist.mesh_axis(mesh, ("pod",))

    def init_fn(seed=0, dtype=torch.float32):
        whole = model.init(seed, dtype)
        leaves, treedef = tree_flatten(whole)
        del whole
        placed, m, v, r = [], [], [], []
        for k, leaf in enumerate(plan):
            x, leaves[k] = leaves[k], None  # the whole leaf goes once sliced
            zshape = shard_shape(mesh, tuple(x.shape), leaf.zspec)
            placed.append(shard_leaf(mesh, x, leaf.spec).requires_grad_())
            del x
            for out in (m, v) + ((r,) if compress_grads else ()):
                out.append(torch.zeros(zshape, dtype=torch.float32,
                                       device=placed[-1].device))
        count = torch.zeros((), dtype=torch.int32, device=placed[0].device)
        return (treedef.unflatten(placed),
                OptState(treedef.unflatten(m), treedef.unflatten(v), count),
                treedef.unflatten(r) if compress_grads else None)

    def rows_of(batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % (microbatches * dp.size):
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{microbatches} microbatches over "
                             f"{dp.size} data ranks")
        size = rows // microbatches
        mine = size // dp.size
        for i in range(microbatches):
            lo = i * size + dp.index * mine
            yield {k: v[lo:lo + mine] for k, v in batch.items()}

    def reduce_grad(g, leaf):
        if dp.group is None:
            return g
        g = g.to(torch.float32)
        if data.group is not None:
            if leaf.zdim is not None:
                g = dist.reduce_scatter(g, data.group, dim=leaf.zdim)
            else:
                g = dist.all_reduce(g.contiguous(), data.group)
        return dist.all_reduce(g.contiguous(), pod.group)

    def grads_microbatched(params, batch):
        leaves, treedef = tree_flatten(params)
        total = None
        acc = [None] * len(leaves)
        for one in rows_of(batch):
            loss = model.loss(params, one, mesh)
            grads = list(torch.autograd.grad(loss, leaves))
            total = loss.detach() if total is None else total + loss.detach()
            del loss    # its graph goes before the next microbatch's forward
            for k, leaf in enumerate(plan):
                g = reduce_grad(grads[k], leaf)
                grads[k] = None     # no whole gradient past its reduction
                if microbatches == 1:
                    acc[k] = g
                elif acc[k] is None:    # 0 + g: the first sum is g itself
                    acc[k] = g.to(torch.float32)
                else:
                    # Out of place: autograd may hand one tensor to two
                    # leaves, or an expanded one, so its outputs are not
                    # written; each old sum is freed as it is replaced.
                    acc[k] = acc[k] + g
            del grads, g    # not held through the next microbatch's backward
        if dp.group is not None:
            total = dist.all_reduce(total.clone(), dp.group)
        if microbatches > 1:
            inv = 1.0 / microbatches
            for k in range(len(acc)):
                acc[k] = acc[k] * inv
            total = total * inv
        return total, treedef.unflatten(acc)

    @torch.no_grad()
    def zero1_slices(params):
        leaves, treedef = tree_flatten(params)
        out = []
        for p, leaf in zip(leaves, plan):
            if leaf.zdim is None or data.group is None:
                out.append(p)
                continue
            n = p.shape[leaf.zdim] // data.size
            out.append(p.narrow(leaf.zdim, data.index * n, n))
        return treedef.unflatten(out)

    @torch.no_grad()
    def gather_slices(params, slices):
        for p, s, leaf in zip(tree_leaves(params), tree_leaves(slices),
                              plan):
            if s is not p:
                p.copy_(dist.all_gather(s, data.group, dim=leaf.zdim))

    def train_step(params, opt_state, residual, batch):
        loss, grads = grads_microbatched(params, batch)
        if compress_grads:
            grads, residual = ef_compress_tree(grads, residual, mesh=mesh,
                                               axes=axes)
        slices = zero1_slices(params)
        _, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                             slices, mesh=mesh, axes=axes)
        del grads
        gather_slices(params, slices)
        metrics["loss"] = loss
        return params, opt_state, residual, metrics

    def jit_for(params_like, batch_like):
        return train_step
    return train_step, init_fn, jit_for


class _Leaf(NamedTuple):
    """One parameter leaf's placement: its spec, its ZeRO-1 spec, the
    dimension ZeRO-1 adds ``data`` on (None when none divides) and the
    mesh axes its ZeRO-1 shard is sharded over."""

    spec: tuple
    zspec: tuple
    zdim: Optional[int]
    axes: Tuple[str, ...]


def _leaf_plan(mesh, whole) -> List[_Leaf]:
    ps, _, zs = train_state_specs(mesh, whole)
    plan = []
    n = len(tree_leaves(whole))
    for spec, zspec in zip(spec_leaves(ps, n), spec_leaves(zs, n)):
        zdim = zspec.index("data") if "data" in zspec else None
        plan.append(_Leaf(spec, zspec, zdim, spec_axes(zspec)))
    return plan


def make_serve_step(model: Model):
    """Returns (serve_step, jit_for(params, states, batch)).

    ``serve_step(params, states, token, position) -> (next_token,
    states)``: one greedy decode step, ``next_token`` (B, 1) int32."""

    def serve_step(params, states, token, position):
        logits, states = model.decode_step(params, token, position, states)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, states

    def jit_for(params_like, states_like, batch_like):
        return serve_step
    return serve_step, jit_for


def make_prefill(model: Model):
    """Returns (prefill, jit_for(params, batch)).

    ``prefill(params, batch) -> (B, 1)`` int32: the greedy next token
    after ``batch["tokens"]`` (with ``patches``/``frames`` for the VLM and
    enc-dec families)."""

    def prefill(params, batch):
        kwargs = {}
        if model.cfg.family == "vlm":
            kwargs["extra_embed"] = batch.get("patches")
        if model.cfg.family == "encdec":
            kwargs["enc_frames"] = batch.get("frames")
        logits, _ = model.forward(params, batch["tokens"], **kwargs)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    def jit_for(params_like, batch_like):
        return prefill
    return prefill, jit_for
