"""Multi-pod dry-run: per-device bytes and FLOPs of every (arch x shape x
mesh) cell, without allocating the model.

The port's counterpart of ``repro.launch.dryrun``. The reference jits
each cell's real step over 512 placeholder host devices and reads XLA's
memory and cost analyses of the partitioned program of one device. The
port has no compiler to ask; it runs the partitioned program of one
device instead, on fake tensors. Its meshes
(:func:`repro_torch.launch.mesh.make_production_mesh`):

* single-pod: 16 x 16  ("data", "model")        = 256 chips
* multi-pod:  2 x 16 x 16 ("pod","data","model") = 512 chips

A record is rank 0's share of its step (the reference's keys, and their
meaning: one device's):

* **argument and output bytes, exact, from the partition specs**
  (:mod:`repro_torch.train.sharding`): every leaf's shard bytes on one
  device (:func:`spec_bytes`). Train takes the bf16 parameters, the
  float32 ZeRO-1 AdamW state and the batch and gives back parameters,
  optimizer state and three scalar metrics; prefill takes parameters
  and the batch and gives the greedy next token; decode takes
  parameters, the bf16 decode states and ``token``/``position`` and
  gives the next token and the states (the reference's
  ``out_shardings``).
* **FLOPs, bytes accessed, collective bytes and temp bytes from a trace
  of the rank's real sharded step.** :func:`cell_record` starts a fake
  world of the mesh's ranks in this process
  (:func:`repro_torch.dist.fake_world`: torch's fake process-group
  backend, whose collectives complete at once and move nothing), lays
  the mesh over it (:func:`repro_torch.launch.mesh.mesh_over_ranks`: 33
  groups on 16 x 16, 355 on 2 x 16 x 16) and runs rank 0's step under
  ``FakeTensorMode`` and :class:`StepTrace`, on this rank's shards of
  the parameters, optimizer state and decode states as fake tensors:
  decode ``make_serve_step(model, mesh)`` and prefill
  ``make_prefill(model, mesh)`` on the whole batch (each rank takes its
  rows), train one microbatch of this rank's rows through
  ``make_train_parts`` (the very step of ``make_train_step``: loss and
  gradients under remat, the reduce-scatter over ``data`` into the
  ZeRO-1 float32 sums that a microbatch after the first holds, then the
  step's end: scale, AdamW on this rank's slices and their all-gather).
  A microbatch's counts are scaled by the microbatches the device runs
  (:data:`MICROBATCHES_BY_ARCH`), the step's end counted once.
  ``flops`` by ``torch.utils.flop_counter``'s formulas;
  ``collective_bytes`` the output operand of every ``c10d`` collective
  the step calls, under the reference's HLO name (all-reduce: its
  tensor; all-gather: the gathered tensor; reduce-scatter: this rank's
  part), as the reference's :func:`collective_bytes` sums an HLO text
  (a collective the reference has no name for keeps its ``c10d`` name
  and gets a note); ``bytes_accessed`` every operator's tensor inputs
  and outputs at numel x itemsize, 0 for one whose outputs are views of
  its inputs, collectives counted like any operator: what eager
  execution reads and writes, the unfused counterpart of XLA's ``bytes
  accessed``, a count and not a measurement, each microbatch counted
  as one after the first; ``temp_bytes`` the rank's peak of live bytes
  less its arguments. ``peak_bytes = argument_bytes + temp_bytes``, as
  in the reference. ``trace.full_width_temp_bytes`` (and
  ``full_width_flops``) are the same step's at the whole width on one
  device at the device's rows, for comparison; a rank that gathers
  whole leaves (a KV head the model axis splits below its width) can
  hold more temp than that.

Train and prefill trace the stacked units at 2 and at 3 (prefix,
suffix and encoder whole) and extrapolate linearly to the config's
depth: exact for the FLOPs and the collectives, since the units are
identical. Train's bytes accessed grow with the square of the depth (each
unit's gradient is a select's backward, a zero tensor the size of the
whole stacked leaf, added into the leaf's gradient), so train is also
traced at 4 units and its bytes accessed taken on the parabola through
the three. The peak of live bytes is extrapolated phase by phase and
the largest taken: train's forward and backward up to the first stacked
unit, its backward of the first and of the last unit (the saved inputs
go as the gradients come, so the peak of the units' backward sits at
one end or the other), the reduction and accumulation and the step's
end; each grows with depth at its own rate, and at full width the peak
moves between them (gemma2-9b x train_4k: at 2 and 3 units the
forward's, at 21 the first unit's backward). The first unit is unlike
the rest, so it gives no slope. A config cut in depth is the same config
with fewer layers (:func:`at_depth`); :func:`trace_step` with
``units=None`` traces every unit, and the tests hold the extrapolation
against it. Decode traces its full depth (a step is one token).
MoE routing is taken balanced under the trace
(``repro_torch.models.blocks._expert_counts``: T*k // E pairs an
expert, the remainder one each to the first experts, which rank 0
holds), which leaves the FLOPs of dropless dispatch over all the ranks
unchanged.

**Heads the model axis does not split.** Where the axis cannot split a
config's heads (``models.blocks.heads_split``; among the configs,
whisper-small's 12 heads over 16 model ranks, in its train, prefill and
decode records on both meshes), every rank runs the attention over all
heads, as GSPMD's whole-head layout would not: those records are rank
0's traced step like every other (``trace.per_rank`` true, collectives
counted), and a note says that a rank's attention FLOPs are the whole
width's. Any failure of the rank's trace fails the record.

No compiler runs: ``compile_s`` is None. :func:`collective_bytes` is
kept for HLO text. On a mesh of one device (``make_host_mesh()``'s
1 x 1) the record is the whole-width trace, with no collectives.
:func:`real_step` runs the real steps a record is held against: on the
card or the host, on one device or as one rank of a running process
group (``mesh=``), with the collective bytes that
``repro_torch.dist``'s wrappers counted.

Usage (on the card, whose memory each record's peak is held against)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-7b \\
      --shape long_500k [--multi-pod | --both-meshes] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

``--device cpu`` runs it on the host against the stated capacity of an
NVIDIA H100 80GB HBM3 (:data:`H100_MEMORY_BYTES`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import dist, obs
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.shapes import shape_applicable
from repro_torch.engine import Engine
from repro_torch.launch.mesh import (Mesh, abstract_mesh,
                                     make_production_mesh, mesh_over_ranks)
from repro_torch.models import build_model, input_specs
from repro_torch.models.blocks import heads_split, tensor_parallel
from repro_torch.models.model import abstract_params
from repro_torch.models.transformer import init_decode_state, stack_plan
from repro_torch.optim import AdamWConfig, OptState
from repro_torch.train import (make_prefill, make_serve_step,
                               make_train_parts, make_train_step)
from repro_torch.train.sharding import (batch_shardings, param_shardings,
                                        shard_shape, state_shardings,
                                        zero1_shardings)
from repro_torch.tree import (tree_flatten, tree_flatten_with_path,
                              tree_leaves, tree_map)

__all__ = ["MICROBATCHES", "MICROBATCHES_BY_ARCH", "COLLECTIVE_RE",
           "SHAPE_RE", "DTYPE_BYTES", "H100_MEMORY_BYTES", "C10D_KINDS",
           "collective_bytes", "abstract_params", "abstract_states",
           "spec_bytes", "train_state_bytes", "StepTrace", "at_depth",
           "trace_step",
           "lower_cell", "whole_width_cell", "cell_record", "real_step",
           "main"]

# No logging side effects at import time: handlers attach only when
# main() calls obs.setup_logging() (see repro_torch.obs.logging).
log = obs.get_logger("dryrun")

# Per-shape microbatch counts (gradient accumulation) keeping one
# microbatch's activations within the per-chip HBM budget.
# PERF(H2): wide/deep archs (granite 52L x 6144) need more accumulation
# steps; MoE archs prefer fewer, larger chunks (dispatch efficiency).
MICROBATCHES = {"train_4k": int(os.environ.get("MB", "8"))}
MICROBATCHES_BY_ARCH = {
    ("granite-20b", "train_4k"): 16,
    ("deepseek-moe-16b", "train_4k"): 16,
    ("phi3.5-moe-42b-a6.6b", "train_4k"): 16,
}

COLLECTIVE_RE = re.compile(
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"[^\n]*?\s+(\S+?)\[([0-9,]*)\]")
SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

# torch.cuda.get_device_properties(0).total_memory of the NVIDIA H100
# 80GB HBM3 that chip_smoke.py's [dryrun] phase reads on the card; the
# capacity that --device cpu holds each record against.
H100_MEMORY_BYTES = 85_017_493_504
H100_NAME = "NVIDIA H100 80GB HBM3"

NOTES = ("rank 0's step on its mesh (one device's share of the "
         "partitioned step): argument and output bytes exact from the "
         "partition specs; flops, bytes_accessed, collective_bytes and "
         "temp_bytes from a FakeTensorMode trace of the port's sharded step "
         "on this rank's shards in a fake process group of the mesh's "
         "ranks, a microbatch's counts times the microbatches plus the "
         "step's end; collective_bytes is each collective's output operand "
         "under the reference's HLO name; bytes_accessed is a count, not a "
         "measurement: every operator's tensor inputs and outputs as eager "
         "execution runs them (views count 0, nothing is fused), each "
         "microbatch counted as one after the first; trace."
         "full_width_temp_bytes is the same step's temp at the whole width "
         "on one device; no compiler runs, so compile_s is null")
HEADS_WHOLE_NOTE = ("heads whole: {} heads do not split over a model axis "
                    "of {}, so every rank runs the attention over all "
                    "heads and a rank's attention FLOPs equal the whole "
                    "width's (the MLP and the vocabulary still split)")


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum output-operand bytes of every collective op in optimized HLO."""
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"^[%\w.\-]+\s*=\s*(.*)$", line)
        if not m:
            continue
        rhs = m.group(1)
        cm = re.search(r"\b(all-gather|all-reduce|reduce-scatter|"
                       r"all-to-all|collective-permute)(-start)?\(", rhs)
        if not cm:
            continue
        kind = cm.group(1)
        # result shape(s) are at the start of the rhs: possibly a tuple
        head = rhs.split(cm.group(0))[0]
        nbytes = 0
        for dt, dims in SHAPE_RE.findall(head):
            if dt not in DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * DTYPE_BYTES[dt]
        out[kind] = out.get(kind, 0) + nbytes
    return out


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}EB"


# ------------------------------------------------------------- specs ----
def abstract_states(cfg, batch: int, cache_len: int,
                    dtype=torch.bfloat16):
    """``cfg``'s decode states for ``batch`` sequences against a
    ``cache_len`` cache, as ``device="meta"`` tensors."""
    return init_decode_state(cfg, batch, cache_len, dtype, device="meta")


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _tree_bytes(mesh: Mesh, tree, specs, itemsize: Optional[int] = None
                ) -> int:
    """One device's bytes of ``tree`` under ``specs`` (a tree of specs
    shaped as ``tree``), each leaf at ``itemsize`` bytes an element or
    its own."""
    leaves = tree_leaves(tree)
    spec_leaves = [s for _, s in tree_flatten_with_path(
        specs, is_leaf=_is_spec)[0]]
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} "
                         f"leaves")
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        n = 1
        for d in shard_shape(mesh, tuple(x.shape), spec):
            n *= d
        total += n * (itemsize or x.element_size())
    return total


def _shape_spec(name: str):
    return next(s for s in SHAPES if s.name == name)


def train_state_bytes(cfg, mesh: Mesh, params=None) -> int:
    """One device's bytes of a train step's parameters (``params``'
    dtype, by the rules) and AdamW state (float32 ``m`` and ``v`` by
    ZeRO-1, and the int32 count) on ``mesh``: what a rank of a sharded
    run places (``TrainRun.placed_bytes``)."""
    if params is None:
        params = abstract_params(cfg)
    p = _tree_bytes(mesh, params, param_shardings(mesh, params))
    opt = 2 * _tree_bytes(mesh, params, zero1_shardings(mesh, params),
                          itemsize=4) + 4
    return p + opt


def spec_bytes(cfg, shape, mesh: Mesh, params=None) -> Tuple[int, int]:
    """(argument bytes, output bytes) of one device of ``mesh`` for the
    step of ``shape`` on ``cfg``, exact from the partition specs; traces
    nothing. ``params``: :func:`abstract_params` of ``cfg`` (made when
    not given)."""
    if params is None:
        params = abstract_params(cfg)
    p = _tree_bytes(mesh, params, param_shardings(mesh, params))
    specs = input_specs(cfg, shape)
    batch = _tree_bytes(mesh, specs, batch_shardings(mesh, specs))
    if shape.kind == "train":
        state = train_state_bytes(cfg, mesh, params)
        metrics = 3 * 4                      # loss, grad_norm, lr
        return state + batch, state + metrics
    # the greedy next token: (B, 1) int32, sharded as the tokens are
    tok = specs["tokens" if shape.kind == "prefill" else "token"]
    nxt = torch.empty((tok.shape[0], 1), dtype=torch.int32, device="meta")
    out = _tree_bytes(mesh, [nxt], [batch_shardings(mesh, {"t": tok})["t"]])
    if shape.kind == "prefill":
        return p + batch, out
    states = abstract_states(cfg, shape.global_batch, shape.seq_len)
    s = _tree_bytes(mesh, states, state_shardings(mesh, states))
    return p + s + batch, s + out


# ------------------------------------------------------------- trace ----
# The reference's HLO names of the c10d operators that repro_torch.dist's
# collectives dispatch to (torch 2.11 and 2.13 alike).
C10D_KINDS = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
              "_reduce_scatter_base_": "reduce-scatter"}
_NOT_MOVED = ("barrier",)      # dist's counter leaves barriers out too


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _writes(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


class StepTrace(TorchDispatchMode):
    """Counts what the operators run under it do: ``flops``, by
    ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    count); ``bytes_accessed``, each operator's tensor inputs and outputs
    at numel x itemsize each, 0 for one whose outputs are views of its
    inputs (a view, ``as_strided``, ``detach``); ``collective_bytes``,
    the output operand of every ``c10d`` collective by the reference's
    HLO name (:data:`C10D_KINDS`; another collective under its ``c10d``
    name, also kept in ``other_kinds``); and the bytes of live storage,
    each storage from the operator that makes it until it is freed,
    starting from the storages of ``args``. ``args_bytes`` is their
    total; ``peak`` the most live at once since the last :meth:`mark`,
    which closes a phase and keeps its peak in ``peaks``."""

    def __init__(self, args):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes: Dict[str, int] = {}
        self.other_kinds: set = set()
        self.live = 0
        self.peak = 0
        self.peaks: list = []
        self._sizes: Dict[int, int] = {}
        self._unit: Optional[int] = None
        for x in tree_leaves(args):
            self._track(x)
        self.args_bytes = self.live

    def counts(self) -> Dict[str, Any]:
        """``flops``, ``bytes_accessed`` and ``collective_bytes`` so far."""
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": dict(self.collective_bytes)}

    def mark(self) -> None:
        """Close a phase: keep its peak, start the next from what is
        live now."""
        self.peaks.append(self.peak)
        self.peak = self.live

    def unit(self, index: int) -> None:
        """Close a phase when backward moves on to stacked unit
        ``index``."""
        if index != self._unit:
            self.mark()
            self._unit = index

    def _track(self, x: torch.Tensor) -> None:
        st = x.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = list(_tensors(list(args) + list(kwargs.values())))
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        held = {id(x.untyped_storage()) for x in ins}
        if func.namespace == "c10d" or _writes(func) or not all(
                id(x.untyped_storage()) in held for x in outs):
            self.bytes_accessed += sum(_nbytes(x) for x in ins + outs)
        if func.namespace == "c10d":
            name = func._overloadpacket.__name__
            if name not in _NOT_MOVED:
                kind = C10D_KINDS.get(name, name)
                if name not in C10D_KINDS:
                    self.other_kinds.add(name)
                self.collective_bytes[kind] = self.collective_bytes.get(
                    kind, 0) + sum(_nbytes(x) for x in _tensors(args[0]))
        for x in outs:
            self._track(x)
        return out


def _fake_shards(mesh: Mesh, tree, specs, dtype=None):
    """``tree`` (meta tensors) as fake tensors of this rank's shards by
    ``specs`` on ``mesh``, in their dtype or ``dtype``: called under
    ``FakeTensorMode``."""
    leaves, treedef = tree_flatten(tree)
    spec_leaves = [sp for _, sp in tree_flatten_with_path(
        specs, is_leaf=_is_spec)[0]]
    return treedef.unflatten([
        torch.empty(shard_shape(mesh, tuple(x.shape), spec),
                    dtype=dtype or x.dtype)
        for x, spec in zip(leaves, spec_leaves)])


def _cut_meta(tree, units: Optional[int]):
    """``tree`` (meta tensors) with its stacked ``scan`` units cut to the
    first ``units`` (all when None)."""
    if units is None:
        return tree
    return {k: (tree_map(lambda x: torch.empty(
        (units, *x.shape[1:]), dtype=x.dtype, device="meta"), v)
        if k == "scan" else v) for k, v in tree.items()}


def _unit_selects(loss: torch.Tensor, stacked) -> list:
    """The autograd nodes that take stacked unit ``i`` out of a leaf of
    ``stacked`` (the ``SelectBackward0`` nodes of the forward's
    ``stacked[i]``), found by walking ``loss``'s graph."""
    ids = {id(x) for x in tree_leaves(stacked)}
    out, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if (node.name() == "SelectBackward0"
                    and type(nxt).__name__ == "AccumulateGrad"
                    and id(nxt.variable) in ids):
                out.append(node)
            todo.append(nxt)
    return out


def at_depth(cfg, units: int):
    """``cfg`` with its stacked units cut to ``units``, prefix, suffix and
    encoder whole: the same config with fewer layers. Raises when the cut
    config's layers do not stack as ``cfg``'s do."""
    prefix, unit, _, suffix = stack_plan(cfg)
    cut = cfg.scaled(n_layers=len(prefix) + units * len(unit) + len(suffix))
    if stack_plan(cut) != (prefix, unit, units, suffix):
        raise ValueError(f"{cfg.name} cut to {units} units stacks as "
                         f"{stack_plan(cut)}")
    return cut


def _minus(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """The counts of :meth:`StepTrace.counts` ``a`` less ``b``."""
    coll = {k: v - b["collective_bytes"].get(k, 0)
            for k, v in a["collective_bytes"].items()}
    return {"flops": a["flops"] - b["flops"],
            "bytes_accessed": a["bytes_accessed"] - b["bytes_accessed"],
            "collective_bytes": {k: v for k, v in coll.items() if v}}


def trace_step(cfg, shape, rows: int, *, units: Optional[int] = None,
               microbatches: int = 1, params=None,
               mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Trace one step of ``shape``'s kind on ``cfg`` under
    ``FakeTensorMode`` and :class:`StepTrace`, on ``cfg`` cut to
    ``units`` stacked units (:func:`at_depth`; all of them when None).
    ``params``: :func:`abstract_params` of ``cfg`` at full depth or at
    ``units`` (cut to ``units`` here).

    ``mesh``: this rank's mesh of ranks (:func:`mesh_over_ranks` under a
    running process group, :func:`repro_torch.dist.fake_world` for the
    dry-run); its parameters, optimizer state and decode states are this
    rank's shards by the partition rules, and the step is the sharded
    step with its collectives. None: one device, the whole width.

    The steps are the port's own: decode ``make_serve_step(model,
    mesh)`` and prefill ``make_prefill(model, mesh)``, given the whole
    batch of ``rows`` rows (each rank takes its rows); train one
    microbatch of ``rows`` rows (this rank's) of a step of
    ``microbatches`` through ``make_train_parts``: loss and gradients
    under remat, their reduction over the data axes into the float32
    sums that a microbatch after the first holds, then the step's end
    (scale, AdamW on this rank's ZeRO-1 slices, their all-gather).

    Returns ``flops``, ``bytes_accessed`` and ``collective_bytes`` (the
    whole trace), ``step`` (the part of those that a train step does
    once, at its end; zeros for the other kinds), ``args_bytes`` (the
    trace's inputs), ``peaks`` (each phase's peak of live bytes: train's
    before the units' backward, of the first and of the last unit's, of
    the reduction and accumulation when there is any, and of the step's
    end; one for the others), ``peak_bytes`` (the largest of every
    phase's), ``other_kinds`` (collectives the reference has no name
    for) and ``seconds``."""
    if units is not None:
        cfg = at_depth(cfg, units)
    if params is None:
        params = abstract_params(cfg)
    params = _cut_meta(params, units)
    model = build_model(cfg, remat=shape.kind == "train",
                        engine=Engine("torch:device=cpu"))
    where = mesh if mesh is not None else abstract_mesh((1, 1),
                                                        ("data", "model"))
    specs = input_specs(cfg, shape)
    t0 = time.perf_counter()
    step: Dict[str, Any] = {"flops": 0, "bytes_accessed": 0,
                            "collective_bytes": {}}
    if shape.kind == "train":
        parts = make_train_parts(model, AdamWConfig(), mesh,
                                 microbatches=microbatches)
        reduces = dist.mesh_axis(mesh, ("pod", "data")).group is not None
    with FakeTensorMode():
        p = _fake_shards(where, params, param_shardings(where, params))
        batch = {k: torch.zeros((rows, *v.shape[1:]), dtype=v.dtype)
                 for k, v in specs.items()}
        if shape.kind == "train":
            tree_map(lambda x: x.requires_grad_(), p)
            zspecs = zero1_shardings(where, params)
            opt = OptState(*(_fake_shards(where, params, zspecs,
                                          dtype=torch.float32)
                             for _ in range(2)),
                           torch.zeros((), dtype=torch.int32))
            with StepTrace((p, opt, batch)) as tr:
                def on_loss(loss):
                    for node in _unit_selects(loss, p["scan"]):
                        node.register_prehook(
                            lambda _, i=node._saved_index: tr.unit(i))
                acc = parts.accumulator(p, held=microbatches > 1)
                loss = parts.microbatch(p, batch, acc, on_loss=on_loss,
                                        on_grads=tr.mark)
                if microbatches > 1 or reduces:
                    tr.mark()
                once = tr.counts()
                parts.finish(p, opt, None, acc, loss)
                del acc, loss
                tr.mark()
                step = _minus(tr.counts(), once)
        elif shape.kind == "prefill":
            prefill, _ = make_prefill(model, mesh)
            with StepTrace((p, batch)) as tr:
                prefill(p, batch)
                tr.mark()
        else:
            states = abstract_states(cfg, rows, shape.seq_len)
            states = _fake_shards(where, states,
                                  state_shardings(where, states))
            serve, _ = make_serve_step(model, mesh)
            with StepTrace((p, states, batch)) as tr:
                serve(p, states, batch["token"], batch["position"])
                tr.mark()
    phases = tr.peaks
    if shape.kind == "train":
        # one phase a unit: keep the first and the last (the peak of
        # those between lies on the line through them)
        phases = phases[:2] + phases[stack_plan(cfg)[2]:]
    return {**tr.counts(), "step": step, "args_bytes": tr.args_bytes,
            "peaks": phases, "peak_bytes": max(tr.peaks),
            "other_kinds": sorted(tr.other_kinds),
            "seconds": time.perf_counter() - t0}


def _rows(mesh: Mesh, cfg, shape) -> int:
    """One device's rows of the batch (all of it when it does not split
    over the data axes)."""
    specs = input_specs(cfg, shape)
    key = "token" if shape.kind == "decode" else "tokens"
    spec = batch_shardings(mesh, {key: specs[key]})[key]
    return shard_shape(mesh, tuple(specs[key].shape), spec)[0]


def _mesh_name(mesh: Mesh) -> str:
    return "x".join(str(n) for n in mesh.axis_sizes)


def _cell(arch: str, shape_name: str, multi_pod: bool):
    """(config, shape, production mesh, microbatches) of a cell, or the
    ``"skipped"`` record where the shape does not apply."""
    cfg = get_config(arch)
    shape = _shape_spec(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    mb = MICROBATCHES_BY_ARCH.get((arch, shape_name),
                                  MICROBATCHES.get(shape_name, 1))
    return cfg, shape, make_production_mesh(multi_pod=multi_pod), mb


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               full_width: bool = True, verbose: bool = True
               ) -> Dict[str, Any]:
    """The record of one (arch x shape) cell on the production mesh,
    with the reference's keys; ``status`` ``"skipped"`` where the shape
    does not apply. ``full_width``: see :func:`cell_record`."""
    cell = _cell(arch, shape_name, multi_pod)
    if isinstance(cell, dict):
        return cell
    cfg, shape, mesh, mb = cell
    return cell_record(cfg, shape, mesh, microbatches=mb,
                       full_width=full_width, verbose=verbose)


def whole_width_cell(arch: str, shape_name: str, *,
                     multi_pod: bool = False) -> Dict[str, Any]:
    """The ``trace.full_width_temp_bytes`` and ``full_width_flops`` of
    :func:`lower_cell`'s record (and their ``seconds``), traced on their
    own, so that they can be traced in another process beside
    ``lower_cell(..., full_width=False)``."""
    cell = _cell(arch, shape_name, multi_pod)
    if isinstance(cell, dict):
        return cell
    cfg, shape, mesh, mb = cell
    rows, n_mb = _device_rows(cfg, shape, mesh, mb)
    return _whole_width(_trace_cell(cfg, shape, rows, n_mb,
                                    abstract_params(cfg), None,
                                    accessed=False))


def _whole_width(full: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return {"full_width_temp_bytes": full and full["temp"],
            "full_width_flops": full and float(full["flops"]),
            "seconds": full and full["seconds"]}


def _device_rows(cfg, shape, mesh: Mesh, microbatches: int
                 ) -> Tuple[int, int]:
    """(rows a step of one device takes at once, the microbatches it
    runs): a train shape splits the device's rows into ``microbatches``
    (one row each where it has fewer rows), the others run them all."""
    rows = _rows(mesh, cfg, shape)
    if shape.kind != "train":
        return rows, 1
    per_mb = max(1, rows // microbatches)
    return per_mb, -(-rows // per_mb)


def _extrapolate(at2, at3, n_units: int):
    """A count traced at 2 and 3 stacked units, at ``n_units``."""
    return at2 + (n_units - 2) * (at3 - at2)


def _quadratic(at2, at3, at4, n_units: int):
    """A count traced at 2, 3 and 4 stacked units that grows with their
    square, at ``n_units`` (the parabola through the three)."""
    return (_extrapolate(at2, at3, n_units)
            + (n_units - 2) * (n_units - 3) // 2 * (at4 - 2 * at3 + at2))


def _counts_at(two: Dict[str, Any], three: Dict[str, Any], n_units: int,
               four: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """:meth:`StepTrace.counts` traced at 2 and 3 units, each count
    extrapolated to ``n_units``; with ``four`` (the counts at 4 units)
    ``bytes_accessed`` on the parabola through the three."""
    kinds = set(two["collective_bytes"]) | set(three["collective_bytes"])
    accessed = (_extrapolate(two["bytes_accessed"], three["bytes_accessed"],
                             n_units) if four is None else
                _quadratic(two["bytes_accessed"], three["bytes_accessed"],
                           four["bytes_accessed"], n_units))
    return {"flops": _extrapolate(two["flops"], three["flops"], n_units),
            "bytes_accessed": accessed,
            "collective_bytes": {k: _extrapolate(
                two["collective_bytes"].get(k, 0),
                three["collective_bytes"].get(k, 0), n_units)
                for k in sorted(kinds)}}


def _trace_cell(cfg, shape, rows: int, n_mb: int, params,
                mesh: Optional[Mesh], accessed: bool = True
                ) -> Dict[str, Any]:
    """One device's counts for a step of ``n_mb`` microbatches from
    :func:`trace_step` (decode and configs of at most three units at
    their depth, the rest traced at 2 and 3 units and extrapolated, and
    train's bytes accessed through 2, 3 and 4 units, unless not
    ``accessed``: then None): ``flops``, ``bytes_accessed`` and
    ``collective_bytes`` with a microbatch's counts times ``n_mb`` plus
    the step's end, ``temp`` (the peak of live bytes less the
    arguments), ``units``, ``other_kinds`` and ``seconds``."""
    n_units = stack_plan(cfg)[2]
    if shape.kind == "decode" or n_units <= 3:
        tr = trace_step(cfg, shape, rows, microbatches=n_mb, params=params,
                        mesh=mesh)
        whole, once = tr, tr["step"]
        temp = tr["peak_bytes"] - tr["args_bytes"]
        units: Any = "all"
        traces = [tr]
    else:
        # train also at 4 units: its bytes accessed grow with the square
        # of the depth (each stacked unit's gradient is a select's
        # backward, a zero tensor the size of the whole stacked leaf,
        # added into the leaf's gradient)
        depths = (2, 3, 4) if shape.kind == "train" and accessed else (2, 3)
        traces = [trace_step(cfg, shape, rows, units=u, microbatches=n_mb,
                             params=params, mesh=mesh) for u in depths]
        two, three, four = (traces + [None])[:3]
        whole = _counts_at(two, three, n_units, four)
        once = _counts_at(two["step"], three["step"], n_units,
                          four and four["step"])
        temp = max(_extrapolate(a - two["args_bytes"],
                                b - three["args_bytes"], n_units)
                   for a, b in zip(two["peaks"], three["peaks"]))
        units = list(depths)
    each = _minus(whole, once)
    kinds = set(each["collective_bytes"]) | set(once["collective_bytes"])
    return {"flops": each["flops"] * n_mb + once["flops"],
            "bytes_accessed": (each["bytes_accessed"] * n_mb
                               + once["bytes_accessed"]) if accessed
            else None,
            "collective_bytes": {k: each["collective_bytes"].get(k, 0) * n_mb
                                 + once["collective_bytes"].get(k, 0)
                                 for k in sorted(kinds)},
            "temp": int(temp), "units": units,
            "other_kinds": sorted({k for t in traces
                                   for k in t["other_kinds"]}),
            "seconds": sum(t["seconds"] for t in traces)}


def cell_record(cfg, shape, mesh: Mesh, *, microbatches: int = 1,
                full_width: bool = True, verbose: bool = False
                ) -> Dict[str, Any]:
    """:func:`lower_cell`'s record for a config, shape and mesh of one's
    own, e.g. ``make_host_mesh()``'s 1 x 1 (a train shape splits each
    device's rows into ``microbatches``).

    On a mesh of more than one device the record is rank 0's: its real
    sharded step traced in a fake world of the mesh's ranks
    (:func:`repro_torch.dist.fake_world`, which raises when a process
    group is running here); where the model axis cannot split the
    config's heads a note says so (:data:`HEADS_WHOLE_NOTE`). Without
    ``full_width`` a rank's record skips the whole-width trace kept for
    comparison (``trace.full_width_*`` None), which halves its time."""
    t0 = time.perf_counter()
    params = abstract_params(cfg)
    args_b, out_b = spec_bytes(cfg, shape, mesh, params)
    rows, n_mb = _device_rows(cfg, shape, mesh, microbatches)
    notes = [NOTES]
    ranked = None
    if mesh.size > 1:
        # the rank's step takes the whole batch of decode and prefill,
        # and its own rows of a train microbatch
        given = rows if shape.kind == "train" else shape.global_batch
        with dist.fake_world(mesh.axis_sizes):
            rank_mesh = mesh_over_ranks(mesh.axis_sizes, mesh.axis_names)
            tp = tensor_parallel(cfg, rank_mesh)
            if tp is not None and cfg.family != "rwkv" \
                    and not heads_split(cfg, tp):
                notes.append(HEADS_WHOLE_NOTE.format(cfg.n_heads, tp.size))
            ranked = _trace_cell(cfg, shape, given, n_mb, params, rank_mesh)
    # the whole width at this device's rows: the temp to compare with
    # (and the record itself on one device)
    full = None
    if full_width or ranked is None:
        full = _trace_cell(cfg, shape, rows, n_mb, params, None,
                           accessed=ranked is None)
    ranked = ranked or full
    flops, accessed = ranked["flops"], ranked["bytes_accessed"]
    coll = ranked["collective_bytes"]
    for kind in ranked["other_kinds"]:
        notes.append(f"collective_bytes[{kind!r}]: a c10d collective "
                     f"with no name in the reference's HLO")
    temp = ranked["temp"]
    trace_s = ranked["seconds"]
    if full is not None and full is not ranked:
        trace_s += full["seconds"]
    rec = {
        "arch": cfg.name, "shape": shape.name, "mesh": _mesh_name(mesh),
        "status": "ok",
        "lower_s": round(time.perf_counter() - t0, 1), "compile_s": None,
        "flops": float(flops),
        "bytes_accessed": float(accessed),
        "per_device": {
            "argument_bytes": args_b,
            "output_bytes": out_b,
            "temp_bytes": temp,
            "peak_bytes": args_b + temp,
        },
        "collective_bytes": coll,
        "trace": {"rows": rows, "microbatches": n_mb,
                  "units": ranked["units"], "n_units": stack_plan(cfg)[2],
                  "per_rank": mesh.size > 1,
                  **{k: v for k, v in _whole_width(full).items()
                     if k != "seconds"},
                  "seconds": round(trace_s, 1)},
        "notes": notes,
    }
    if verbose:
        pd = rec["per_device"]
        print(f"  [{rec['mesh']}] {cfg.name} x {shape.name}: "
              f"flops={rec['flops']:.3e} "
              f"accessed={_fmt_bytes(rec['bytes_accessed'])} "
              f"args={_fmt_bytes(pd['argument_bytes'])} "
              f"temp={_fmt_bytes(pd['temp_bytes'])} "
              f"(full width {full and _fmt_bytes(full['temp'])}) "
              f"peak={_fmt_bytes(pd['peak_bytes'])} "
              f"collectives={coll} per_rank={mesh.size > 1} "
              f"(trace {trace_s:.1f}s, units {ranked['units']})",
              flush=True)
    return rec


def _random_batch(cfg, shape, gen: torch.Generator, dev) -> Dict[str, Any]:
    """A whole batch of ``shape``'s inputs from ``gen``: random tokens
    (and labels), random patches or frames."""
    return {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                             generator=gen, dtype=v.dtype, device=dev)
            if v.dtype == torch.int32 else
            torch.randn(tuple(v.shape), generator=gen, device=dev
                        ).to(v.dtype)
            for k, v in input_specs(cfg, shape).items()}


def real_step(cfg, shape, *, microbatches: int = 1, steps: int = 4,
              seed: int = 0, mesh: Optional[Mesh] = None,
              device: Optional[str] = None) -> Dict[str, Any]:
    """The check of a record against real steps: ``cfg``'s bf16
    parameters (from ``seed``) with what the step of ``shape`` takes,
    then ``steps`` real steps, the first a warm-up. Decode: the decode
    states, ``token`` and ``position`` and greedy steps through
    ``make_serve_step``. Prefill: a random batch through
    ``make_prefill``. Train: AdamW's float32 state, a batch of random
    tokens, and steps of ``make_train_step`` over ``microbatches`` with
    remat, the parameters bf16 as the record takes them.

    ``mesh``: this rank's mesh under a running process group
    (``make_host_mesh``); the tensors are then this rank's shards
    (``model.init(..., mesh=mesh)``, ``init_decode_state(..., mesh=mesh)``,
    the train step's ``init_fn``) and the steps the sharded ones, which
    every rank runs together. ``device``: None for the card (the port's
    default engine), ``"cpu"`` for the host.

    Returns ``argument_bytes`` (this rank's: the bytes of those tensors,
    the batch's rows as ``batch_shardings`` gives them to the rank),
    ``peak_bytes`` (on the card ``torch.cuda.max_memory_allocated`` over
    every step above what the device held before the tensors were
    built; on the host the arguments plus the most live above them in
    any step, by :class:`StepTrace`), ``temp_bytes`` (on the card the
    most a step after the warm-up allocated above what was live when it
    started: what the warm-up leaves held, such as cuBLAS's workspace,
    is not the step's; on the host the least of the steps after the
    warm-up, each its most live above its arguments, since gloo's
    worker thread may let go of a collective's buffers after the step
    has moved on), ``flops`` (``FlopCounterMode``'s count of the warm-up
    step), ``collective_bytes`` (what ``repro_torch.dist``'s collectives
    moved in the last step, by kind, counted in the wrappers,
    independently of the trace), ``ms`` (the median of the steps after
    the first, by CUDA events on the card, the host clock on the host),
    ``step_ms`` (each step's) and ``outputs`` (each step's next tokens,
    or ``[loss]``)."""
    if steps < 2:
        raise ValueError(f"steps must be >= 2 (a warm-up, then the "
                         f"measured), got {steps}")
    if device not in (None, "cpu"):
        raise ValueError(f"device {device!r}: None (the card) or 'cpu'")
    engine = Engine("torch:device=cpu") if device == "cpu" else None
    model = build_model(cfg, remat=shape.kind == "train", engine=engine)
    dev = model.device
    on_card = dev.type == "cuda"
    where = mesh if mesh is not None else abstract_mesh((1, 1),
                                                        ("data", "model"))
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
    b = shape.global_batch
    gen = torch.Generator(device=dev).manual_seed(seed)
    if shape.kind == "decode":
        params = model.init(seed, torch.bfloat16, mesh=mesh)
        states = model.init_decode_state(b, shape.seq_len, torch.bfloat16,
                                         mesh=mesh)
        token = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        position = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        batch = {"token": token, "position": position}
        serve, _ = make_serve_step(model, mesh)
        placed = (params, states)

        def run(i: int):
            nonlocal states, token
            token, states = serve(params, states, token, position + i)
            return token
    elif shape.kind == "prefill":
        params = model.init(seed, torch.bfloat16, mesh=mesh)
        batch = _random_batch(cfg, shape, gen, dev)
        prefill, _ = make_prefill(model, mesh)
        placed = (params,)

        def run(i: int):
            return prefill(params, batch)
    else:
        train, init_fn, _ = make_train_step(model, AdamWConfig(), mesh,
                                            microbatches=microbatches)
        params, opt, _ = init_fn(seed, torch.bfloat16)
        batch = _random_batch(cfg, shape, gen, dev)
        placed = (params, opt)

        def run(i: int):
            nonlocal params, opt
            params, opt, _, metrics = train(params, opt, None, batch)
            return metrics["loss"]

    def held():
        if shape.kind == "decode":
            return params, states, token, position
        return (params, batch) if shape.kind == "prefill" else \
            (params, opt, batch)
    allocated = sum(_nbytes(x) for x in tree_leaves(placed)) + _tree_bytes(
        where, batch, batch_shardings(where, batch))
    del placed
    times, outputs, temps = [], [], []
    flops, peak, before = 0, 0, 0
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(steps):
        if on_card and i == 1:
            peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        if i == steps - 1:
            dist.reset_collective_bytes()
        counter = FlopCounterMode(display=False) if i == 0 else None
        live = None if on_card else StepTrace(held())
        t0 = time.perf_counter()
        if on_card:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        with counter or contextlib.nullcontext(), \
                live or contextlib.nullcontext():
            out = run(i)
            if live is not None:
                live.mark()
        if on_card:
            ev1.record()
            torch.cuda.synchronize(dev)
            times.append(ev0.elapsed_time(ev1))
        else:
            times.append((time.perf_counter() - t0) * 1e3)
            temps.append(max(live.peaks) - live.args_bytes)
            del live
        if counter is not None:
            flops = counter.get_total_flops()
        outputs.append(out.flatten().tolist())
    moved = dist.collective_bytes()
    if on_card:
        high = torch.cuda.max_memory_allocated(dev)
        peak_b, temp_b = max(peak, high) - base, high - before
    else:
        # gloo's worker thread can let go of a collective's buffers after
        # the step has moved on, which adds to a step's live bytes at
        # random and never takes from them: the least measured step
        peak_b, temp_b = allocated + max(temps), min(temps[1:])
    return {"argument_bytes": allocated, "peak_bytes": peak_b,
            "temp_bytes": temp_b, "flops": flops,
            "collective_bytes": moved,
            "ms": statistics.median(times[1:]), "step_ms": times,
            "outputs": outputs}


def _card(device: Optional[str]) -> Tuple[str, int]:
    """(name, memory bytes) of the card the records are held against."""
    if device == "cpu":
        return H100_NAME + " (stated capacity; run on the host)", \
            H100_MEMORY_BYTES
    if not torch.cuda.is_available():
        raise RuntimeError("the dry-run holds each cell against the card's "
                           "memory and CUDA is not available; pass "
                           "--device cpu to hold it against the stated "
                           f"capacity of an {H100_NAME}")
    props = torch.cuda.get_device_properties(0)
    return props.name, props.total_memory


def main(argv=None) -> None:
    """Parse the flags, run the cells, write the records (after every
    cell) and exit 1 if any cell failed."""
    ap = argparse.ArgumentParser(
        description="Multi-pod dry-run of the port: per-device bytes and "
                    "FLOPs of each (arch x shape) cell against the card's "
                    "memory.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--rank-only", action="store_true",
                    help="skip the whole-width trace kept beside each "
                         "rank's for comparison (trace.full_width_* null; "
                         "half the trace time)")
    ap.add_argument("--device", default=None, choices=("cpu",),
                    help="cpu: run on the host against the stated capacity "
                         f"of an {H100_NAME}; default: the card's memory")
    args = ap.parse_args(argv)
    name, capacity = _card(args.device)
    obs.setup_logging()
    print(f"holding each cell against {name}: {capacity} bytes", flush=True)

    if args.all:
        cells = [(arch, s.name) for arch in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    failed = 0
    for arch, shp in cells:
        for mp in meshes:
            try:
                rec = lower_cell(arch, shp, multi_pod=mp,
                                 full_width=not args.rank_only)
                if rec["status"] == "ok":
                    peak = rec["per_device"]["peak_bytes"]
                    rec["card"] = {"name": name, "memory_bytes": capacity,
                                   "fits": peak <= capacity}
                    print(f"    peak {peak / 1e9:.3f} GB of "
                          f"{capacity / 1e9:.3f} GB: fits="
                          f"{peak <= capacity}", flush=True)
                results.append(rec)
            except Exception as e:   # noqa: BLE001
                failed += 1
                traceback.print_exc()
                results.append({"arch": arch, "shape": shp,
                                "mesh": "2x16x16" if mp else "16x16",
                                "status": "error", "error": str(e)})
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    log.info("dry-run: %d ok, %d skipped, %d failed -> %s",
             n_ok, n_skip, failed, args.out)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
