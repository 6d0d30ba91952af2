"""Train-step, serve-step and prefill factories (the port's copy of
``repro.train.step``).

The reference jits each step with explicit shardings over its mesh and
donates its buffers. The port's ``jit_for`` returns the step itself (no
``torch.compile``); the optimizer updates the parameters and moments in
place and the decode states update in place
(:func:`repro_torch.models.transformer.decode_step`), which is what the
reference's donation buys. Over a mesh of ``torch.distributed`` ranks
every step is sharded as the reference's shardings say (one process is
the mesh of one device, where every collective is the identity): the
train step tensor parallel over ``model`` (the blocks' layout), data
parallel over ``pod``/``data`` with ZeRO-1 (see
:func:`make_train_step`); the serve step and prefill the same way, on
this rank's rows of the batch, with decode states placed by
``state_shardings`` and the greedy token an argmax over the vocabulary
shards (:func:`make_serve_step`, :func:`greedy_token`).

``make_train_step``: a microbatched (gradient-accumulation) AdamW step.
Forward and backward run one microbatch at a time, so only one
microbatch's activations are ever live (the reference's ``value_and_grad``
inside its ``lax.scan``); with a model built with ``remat=True`` each
stacked unit is also rematerialised in backward.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import dist
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.blocks import tensor_parallel
from repro_torch.models.model import Model, abstract_params
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update
from repro_torch.optim.compress import ef_compress_tree
from repro_torch.tree import tree_flatten, tree_leaves

from .sharding import (shard_shape, spec_axes, spec_leaves,
                       train_state_specs)

__all__ = ["make_train_step", "make_train_parts", "TrainParts",
           "make_serve_step", "make_prefill",
           "greedy_token", "batch_rows", "gather_rows"]


def make_train_step(model: Model, opt_cfg: AdamWConfig, mesh=None, *,
                    microbatches: int = 1, compress_grads: bool = False):
    """Returns ``(train_step, init_fn, jit_for)``, over ``mesh``: a
    :class:`repro_torch.launch.mesh.Mesh` over ``torch.distributed``
    ranks (``make_host_mesh`` under a process group), or None or a mesh
    of one device without process groups (one process, where every
    collective below is the identity). The reference's ``jit_for`` made
    explicit:

    * ``init_fn(seed=0, dtype=float32) -> (params, opt_state,
      residual)``: the whole model's draws from ``seed`` (so a run's
      numbers do not depend on the mesh), each leaf sliced to this
      rank's shard by its spec as it is drawn (``model.init(...,
      mesh=mesh)``) and ``requires_grad_``; AdamW's float32 ``m``/``v`` and,
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
    parts = make_train_parts(model, opt_cfg, mesh, microbatches=microbatches,
                             compress_grads=compress_grads)

    def train_step(params, opt_state, residual, batch):
        acc = parts.accumulator(params, held=False)
        total = None
        for one in parts.rows_of(batch):
            loss = parts.microbatch(params, one, acc)
            total = loss if total is None else total + loss
        return parts.finish(params, opt_state, residual, acc, total)

    def jit_for(params_like, batch_like):
        return train_step
    return train_step, parts.init_fn, jit_for


class TrainParts(NamedTuple):
    """:func:`make_train_step`'s step in the parts that it runs once a
    microbatch and once a step, so that the dry-run can trace one
    microbatch and the step's end of the very same code.

    * ``init_fn``: as :func:`make_train_step` describes it.
    * ``rows_of(batch)``: this rank's rows of each microbatch of the
      whole global batch, in turn.
    * ``accumulator(params, held=True)``: the gradient sums, one a leaf:
      with ``held``, float32 zeros shaped as each reduced gradient (the
      ZeRO-1 shard where ``data`` splits it), what a step of more than
      one microbatch holds when a microbatch after the first starts; else
      a list of None, the first microbatch's.
    * ``microbatch(params, one, acc, on_loss=None, on_grads=None)``: the
      loss and gradients of the rows ``one``, each gradient reduced over
      the data axes (reduce-scatter over ``data`` into its ZeRO-1 shard,
      or an all-reduce where no dimension divides; all-reduce over
      ``pod``) and added into ``acc`` in place, a leaf at a time;
      returns the detached loss. ``on_loss(loss)`` is called before the
      backward and ``on_grads()`` after it (the dry-run's phases).
    * ``finish(params, opt_state, residual, acc, total)``: the step's
      end: the loss summed over the data ranks, the sums scaled by
      ``1 / microbatches``, error feedback, AdamW on this rank's ZeRO-1
      slices and their all-gather back into ``params``; returns what
      :func:`make_train_step`'s ``train_step`` does."""

    init_fn: Any
    rows_of: Any
    accumulator: Any
    microbatch: Any
    finish: Any


def make_train_parts(model: Model, opt_cfg: AdamWConfig, mesh=None, *,
                     microbatches: int = 1,
                     compress_grads: bool = False) -> TrainParts:
    """The :class:`TrainParts` of :func:`make_train_step` over
    ``mesh``."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    mesh = _mesh_of_ranks(mesh)
    plan = _leaf_plan(mesh, abstract_params(model.cfg))
    axes = [leaf.axes for leaf in plan]
    dp = dist.mesh_axis(mesh, ("pod", "data"))
    data = dist.mesh_axis(mesh, ("data",))
    pod = dist.mesh_axis(mesh, ("pod",))

    def init_fn(seed=0, dtype=torch.float32):
        placed, treedef = tree_flatten(model.init(seed, dtype, mesh=mesh))
        m, v, r = [], [], []
        for x, leaf in zip(placed, plan):
            x.requires_grad_()
            zshape = shard_shape(mesh, leaf.shape, leaf.zspec)
            for out in (m, v) + ((r,) if compress_grads else ()):
                out.append(torch.zeros(zshape, dtype=torch.float32,
                                       device=x.device))
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

    def accumulator(params, held=True):
        if not held:
            return [None] * len(plan)
        dev = tree_leaves(params)[0].device
        return [torch.zeros(shard_shape(mesh, leaf.shape, leaf.zspec),
                            dtype=torch.float32, device=dev)
                for leaf in plan]

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

    def microbatch(params, one, acc, on_loss=None, on_grads=None):
        leaves = tree_leaves(params)
        loss = model.loss(params, one, mesh)
        if on_loss is not None:
            on_loss(loss)
        grads = list(torch.autograd.grad(loss, leaves))
        out = loss.detach()
        del loss    # its graph goes before the next microbatch's forward
        if on_grads is not None:
            on_grads()
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
        return out

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

    def finish(params, opt_state, residual, acc, total):
        if dp.group is not None:
            total = dist.all_reduce(total.clone(), dp.group)
        if microbatches > 1:
            inv = 1.0 / microbatches
            for k in range(len(acc)):
                acc[k] = acc[k] * inv
            total = total * inv
        grads = tree_flatten(params)[1].unflatten(acc)
        del acc[:]
        if compress_grads:
            grads, residual = ef_compress_tree(grads, residual, mesh=mesh,
                                               axes=axes)
        slices = zero1_slices(params)
        _, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                             slices, mesh=mesh, axes=axes)
        del grads
        gather_slices(params, slices)
        metrics["loss"] = total
        return params, opt_state, residual, metrics

    return TrainParts(init_fn, rows_of, accumulator, microbatch, finish)


class _Leaf(NamedTuple):
    """One parameter leaf's placement: its whole shape, its spec, its
    ZeRO-1 spec, the dimension ZeRO-1 adds ``data`` on (None when none
    divides) and the mesh axes its ZeRO-1 shard is sharded over."""

    shape: Tuple[int, ...]
    spec: tuple
    zspec: tuple
    zdim: Optional[int]
    axes: Tuple[str, ...]


def _leaf_plan(mesh, whole) -> List[_Leaf]:
    ps, _, zs = train_state_specs(mesh, whole)
    plan = []
    leaves = tree_leaves(whole)
    n = len(leaves)
    for x, spec, zspec in zip(leaves, spec_leaves(ps, n),
                              spec_leaves(zs, n)):
        zdim = zspec.index("data") if "data" in zspec else None
        plan.append(_Leaf(tuple(x.shape), spec, zspec, zdim,
                          spec_axes(zspec)))
    return plan


def _mesh_of_ranks(mesh):
    """``mesh``, or the one-device mesh for None; raises for a mesh of
    several devices without process groups."""
    if mesh is None:
        return abstract_mesh((1, 1), ("data", "model"))
    if mesh.comm is None and mesh.size > 1:
        raise ValueError(f"a mesh of {mesh.size} devices without process "
                         f"groups: run one process a rank under "
                         f"torch.distributed (make_host_mesh)")
    return mesh


def batch_rows(mesh, n: int):
    """This rank's rows of a global batch of ``n``: ``(take, dp)``,
    ``take(x)`` the rank's block of ``x``'s rows over the data axes and
    ``dp`` their :class:`ParallelAxis` when they divide ``n``
    (``batch_shardings``), else the identity and None (the batch stays
    whole on every rank)."""
    dp = dist.mesh_axis(mesh, ("pod", "data"))
    if dp.group is None or n % dp.size:
        return (lambda x: x), None
    m = n // dp.size
    return (lambda x: x[dp.index * m:(dp.index + 1) * m]), dp


def gather_rows(x: torch.Tensor, dp) -> torch.Tensor:
    """The whole batch of the ranks' rows ``x`` (:func:`batch_rows`'
    ``dp``; None: ``x`` is whole already)."""
    return x if dp is None else dist.all_gather(x, dp.group, dim=0)


def greedy_token(cfg, logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """The greedy next token (B, 1) int32 of ``logits`` (B, S, V)' last
    position: the first maximal index, as ``jnp.argmax``/``torch.argmax``
    give it. Over a ``model`` axis the logits are this rank's shard of
    the vocabulary: each rank takes its maximum and its first index (plus
    the shard's offset), the ranks gather both (one collective, float64,
    which holds a float32 and an index exactly), and the largest value
    wins, the lowest rank (so the lowest index) on a tie."""
    last = logits[:, -1]
    tp = tensor_parallel(cfg, mesh)
    if tp is None or last.shape[-1] == cfg.vocab_size:
        return torch.argmax(last, dim=-1, keepdim=True).to(torch.int32)
    idx = torch.argmax(last, dim=-1, keepdim=True)
    val = torch.gather(last, -1, idx)
    mine = torch.cat([val.to(torch.float64),
                      (idx + tp.index * last.shape[-1]).to(torch.float64)],
                     dim=-1)
    every = dist.all_gather(mine[None], tp.group, dim=0)     # (tp, B, 2)
    win = torch.argmax(every[..., 0], dim=0, keepdim=True)   # first max
    return every[..., 1].gather(0, win)[0, :, None].to(torch.int32)


def make_serve_step(model: Model, mesh=None):
    """Returns (serve_step, jit_for(params, states, batch)), over
    ``mesh`` as :func:`make_train_step` takes it.

    ``serve_step(params, states, token, position) -> (next_token,
    states)``: one greedy decode step. Every rank passes the whole
    ``token``/``position`` (B, 1) and gets the whole ``next_token`` (B, 1)
    int32; it decodes its rows (:func:`batch_rows`) on its shards of
    ``params`` and ``states`` (``model.init_decode_state(..., mesh=mesh)``,
    updated in place), takes the greedy token over the vocabulary shards
    (:func:`greedy_token`) and gathers the rows. ``jit_for`` returns
    ``serve_step``."""
    mesh = _mesh_of_ranks(mesh)

    def serve_step(params, states, token, position):
        rows, dp = batch_rows(mesh, token.shape[0])
        logits, states = model.decode_step(params, rows(token),
                                           rows(position), states,
                                           mesh=mesh)
        return gather_rows(greedy_token(model.cfg, logits, mesh), dp), states

    def jit_for(params_like, states_like, batch_like):
        return serve_step
    return serve_step, jit_for


def make_prefill(model: Model, mesh=None):
    """Returns (prefill, jit_for(params, batch)), over ``mesh`` as
    :func:`make_serve_step` takes it.

    ``prefill(params, batch) -> (B, 1)`` int32: the greedy next token
    after ``batch["tokens"]`` (with ``patches``/``frames`` for the VLM and
    enc-dec families), the whole batch on every rank, each rank running
    the forward on its rows and shards."""
    mesh = _mesh_of_ranks(mesh)

    def prefill(params, batch):
        rows, dp = batch_rows(mesh, batch["tokens"].shape[0])
        kwargs = {}
        for key, arg, family in (("patches", "extra_embed", "vlm"),
                                 ("frames", "enc_frames", "encdec")):
            if model.cfg.family == family and batch.get(key) is not None:
                kwargs[arg] = rows(batch[key])
        logits, _ = model.forward(params, rows(batch["tokens"]), mesh=mesh,
                                  **kwargs)
        return gather_rows(greedy_token(model.cfg, logits, mesh), dp)

    def jit_for(params_like, batch_like):
        return prefill
    return prefill, jit_for
