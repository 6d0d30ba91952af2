"""Multi-pod dry-run: per-device bytes and FLOPs of every (arch x shape x
mesh) cell, without allocating the model.

The port's counterpart of ``repro.launch.dryrun``. The reference jits
each cell's real step over 512 placeholder host devices and reads XLA's
memory and cost analyses of the compiled program. The port has no
compiler to ask, and its meshes are abstract
(:func:`repro_torch.launch.mesh.make_production_mesh`):

* single-pod: 16 x 16  ("data", "model")        = 256 chips
* multi-pod:  2 x 16 x 16 ("pod","data","model") = 512 chips

Each record has two sources:

* **argument and output bytes, exact, from the partition specs**
  (:mod:`repro_torch.train.sharding`): every leaf's shard bytes on one
  device (:func:`spec_bytes`). Train takes the bf16 parameters, the
  float32 ZeRO-1 AdamW state and the batch and gives back parameters,
  optimizer state and three scalar metrics; prefill takes parameters
  and the batch and gives the greedy next token; decode takes
  parameters, the bf16 decode states and ``token``/``position`` and
  gives the next token and the states (the reference's
  ``out_shardings``).
* **FLOPs and temp bytes from a trace** of the real step under
  ``FakeTensorMode`` (shapes only, nothing allocated), counted by
  :class:`StepTrace`: train is ``make_train_step``'s loss and gradients
  with remat plus the AdamW update, prefill ``make_prefill``, decode
  ``make_serve_step``. The trace runs at the per-device batch (the
  global batch over the data axes), train at one microbatch of it
  (:data:`MICROBATCHES_BY_ARCH`) with the FLOPs scaled by the
  microbatches the device runs. ``flops`` is the trace's count over the
  model-axis size. ``temp_bytes`` is the trace's peak of live bytes
  minus its arguments; the trace keeps the full width, so it ignores
  tensor parallelism's split of activations and gradients: **an upper
  bound**. ``peak_bytes = argument_bytes + temp_bytes``, as in the
  reference.

Train and prefill trace the stacked units at 2 and at 3 (prefix,
suffix and encoder whole) and extrapolate linearly to the config's
depth: exact for the FLOPs, since the units are identical. The peak of
live bytes is extrapolated phase by phase and the largest taken: train's
forward and backward up to the first stacked unit, its backward of the
first and of the last unit (the saved inputs go as the gradients come,
so the peak of the units' backward sits at one end or the other), the
accumulation and the update; each grows with depth at its own rate, and
at full width the peak moves between them (gemma2-9b x train_4k: at 2
and 3 units the forward's, at 21 the first unit's backward). The first
unit is unlike the rest, so it gives no slope. A config cut in depth is
the same config with fewer layers (:func:`at_depth`); :func:`trace_step`
with ``units=None`` traces every unit, and the tests hold the
extrapolation against it. Decode traces its full depth (a step is one
token).
MoE routing is taken balanced under the trace
(``repro_torch.models.blocks._expert_counts``), which leaves the FLOPs
of dropless dispatch unchanged. A train step of more than one
microbatch holds a float32 gradient accumulator (full width); the trace
holds it too.

There is no compiled, partitioned program: ``compile_s`` and
``bytes_accessed`` are ``None`` and ``collective_bytes`` is ``{}`` (each
record's ``notes`` say so); :func:`collective_bytes` is kept for HLO
text. The records keep the reference's keys.

Usage (on the card, whose memory each record's peak is held against)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-7b \\
      --shape long_500k [--multi-pod | --both-meshes] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

``--device cpu`` runs it on the host against the stated capacity of an
NVIDIA H100 80GB HBM3 (:data:`H100_MEMORY_BYTES`).
"""
from __future__ import annotations

import argparse
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
from torch.utils.flop_counter import flop_registry

from repro_torch import obs
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.shapes import shape_applicable
from repro_torch.engine import Engine
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import build_model, input_specs
from repro_torch.models.model import abstract_params
from repro_torch.models.transformer import init_decode_state, stack_plan
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train import make_prefill, make_serve_step, make_train_step
from repro_torch.train.sharding import (batch_shardings, param_shardings,
                                        shard_shape, state_shardings,
                                        zero1_shardings)
from repro_torch.tree import (tree_flatten, tree_flatten_with_path,
                              tree_leaves, tree_map)

__all__ = ["MICROBATCHES", "MICROBATCHES_BY_ARCH", "COLLECTIVE_RE",
           "SHAPE_RE", "DTYPE_BYTES", "H100_MEMORY_BYTES",
           "collective_bytes", "abstract_params", "abstract_states",
           "spec_bytes", "train_state_bytes", "StepTrace", "at_depth",
           "trace_step",
           "lower_cell", "cell_record", "real_step", "main"]

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

NOTES = ("no compiled, partitioned program: compile_s and bytes_accessed "
         "are null and collective_bytes is empty (collectives wait for the "
         "specs applied through torch.distributed); argument and output "
         "bytes are exact from the partition specs; flops and temp_bytes "
         "come from a FakeTensorMode trace at the per-device batch and full "
         "width, so temp_bytes (and peak_bytes) is an upper bound")


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
class StepTrace(TorchDispatchMode):
    """Counts what the operators run under it do: ``flops``, by
    ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    count), and the bytes of live storage, each storage from the
    operator that makes it until it is freed, starting from the storages
    of ``args``. ``args_bytes`` is their total; ``peak`` the most live
    at once since the last :meth:`mark`, which closes a phase and keeps
    its peak in ``peaks``."""

    def __init__(self, args):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.peaks: list = []
        self._sizes: Dict[int, int] = {}
        self._unit: Optional[int] = None
        for x in tree_leaves(args):
            self._track(x)
        self.args_bytes = self.live

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
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(x, torch.Tensor):
                self._track(x)
        return out


def _fake(x: torch.Tensor, units: Optional[int] = None) -> torch.Tensor:
    """A fake tensor shaped as ``x`` (its leading axis ``units`` when
    given): called under ``FakeTensorMode``."""
    shp = tuple(x.shape) if units is None else (units, *x.shape[1:])
    return torch.empty(shp, dtype=x.dtype)


def _cut(tree, units: Optional[int]):
    """``tree`` (parameters or decode states, as meta tensors) as fake
    tensors, its stacked ``scan`` units cut to the first ``units``."""
    return {k: (tree_map(lambda x: _fake(x, units), v) if k == "scan"
                else tree_map(_fake, v)) for k, v in tree.items()}


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


def _train_microbatch(model, params, opt, batch, microbatches: int,
                      tr: StepTrace) -> None:
    """One microbatch of ``make_train_step``'s step: its loss and
    gradients (``model.loss`` under remat, then ``torch.autograd.grad``),
    summed into the float32 accumulator that a step of more than one
    microbatch holds, then the AdamW update.

    Phases (:meth:`StepTrace.mark`): the forward and backward up to the
    first stacked unit's gradients, one phase a stacked unit as backward
    reaches it (:meth:`StepTrace.unit`, from the unit's select nodes),
    the accumulation, the update. The peak can sit at either end of the
    units' backward (the saved inputs go as the gradients come), so the
    first and the last unit's phases are kept apart."""
    leaves, treedef = tree_flatten(params)
    acc = None
    if microbatches > 1:   # what the earlier microbatches left behind
        acc = [torch.zeros(x.shape, dtype=torch.float32) for x in leaves]
    loss = model.loss(params, batch)
    for node in _unit_selects(loss, params["scan"]):
        node.register_prehook(lambda _, i=node._saved_index: tr.unit(i))
    grads = list(torch.autograd.grad(loss, leaves))
    del loss
    tr.mark()
    if acc is not None:    # the step's sum and scale, a leaf at a time
        for k, g in enumerate(grads):
            acc[k] = acc[k] + g
        del grads, g
        for k in range(len(acc)):
            acc[k] = acc[k] * (1.0 / microbatches)
        grads = acc
        del acc
        tr.mark()
    adamw_update(AdamWConfig(), treedef.unflatten(grads), opt, params)


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


def trace_step(cfg, shape, rows: int, *, units: Optional[int] = None,
               microbatches: int = 1, params=None) -> Dict[str, Any]:
    """Trace one step of ``shape``'s kind on ``cfg`` at ``rows`` rows of
    the batch under ``FakeTensorMode`` and :class:`StepTrace`, on
    ``cfg`` cut to ``units`` stacked units (:func:`at_depth`; all of them
    when None). ``params``: :func:`abstract_params` of ``cfg`` at full
    depth or at ``units`` (cut to ``units`` here). Train is one
    microbatch of a step of ``microbatches``
    (:func:`_train_microbatch`), prefill ``make_prefill``, decode
    ``make_serve_step``.

    Returns ``flops``, ``args_bytes`` (the trace's inputs: full-width
    parameters, optimizer state or decode states, and the batch),
    ``peaks`` (each phase's peak of live bytes: train's before the units'
    backward, of the first and of the last unit's, of the accumulation
    and of the update; one for the others), ``peak_bytes`` (the largest
    of every phase's) and ``seconds``."""
    if units is not None:
        cfg = at_depth(cfg, units)
    if params is None:
        params = abstract_params(cfg)
    model = build_model(cfg, remat=shape.kind == "train",
                        engine=Engine("torch:device=cpu"))
    specs = input_specs(cfg, shape)
    t0 = time.perf_counter()
    with FakeTensorMode():
        p = _cut(params, units)
        batch = {k: torch.zeros((rows, *v.shape[1:]), dtype=v.dtype)
                 for k, v in specs.items()}
        if shape.kind == "train":
            tree_map(lambda x: x.requires_grad_(), p)
            opt = adamw_init(p)
            with StepTrace((p, opt, batch)) as tr:
                _train_microbatch(model, p, opt, batch, microbatches, tr)
                tr.mark()
        elif shape.kind == "prefill":
            prefill, _ = make_prefill(model)
            with StepTrace((p, batch)) as tr:
                prefill(p, batch)
                tr.mark()
        else:
            states = _cut(abstract_states(cfg, rows, shape.seq_len), None)
            serve, _ = make_serve_step(model)
            with StepTrace((p, states, batch)) as tr:
                serve(p, states, batch["token"], batch["position"])
                tr.mark()
    phases = tr.peaks
    if shape.kind == "train":
        # one phase a unit: keep the first and the last (the peak of
        # those between lies on the line through them)
        phases = phases[:2] + phases[stack_plan(cfg)[2]:]
    return {"flops": tr.flops, "args_bytes": tr.args_bytes,
            "peaks": phases, "peak_bytes": max(tr.peaks),
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


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True) -> Dict[str, Any]:
    """The record of one (arch x shape) cell on the production mesh,
    with the reference's keys; ``status`` ``"skipped"`` where the shape
    does not apply."""
    cfg = get_config(arch)
    shape = _shape_spec(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    mb = MICROBATCHES_BY_ARCH.get((arch, shape_name),
                                  MICROBATCHES.get(shape_name, 1))
    return cell_record(cfg, shape, mesh, microbatches=mb, verbose=verbose)


def _extrapolate(at2, at3, n_units: int):
    """A count traced at 2 and 3 stacked units, at ``n_units``."""
    return at2 + (n_units - 2) * (at3 - at2)


def cell_record(cfg, shape, mesh: Mesh, *, microbatches: int = 1,
                verbose: bool = False) -> Dict[str, Any]:
    """:func:`lower_cell`'s record for a config, shape and mesh of one's
    own, e.g. ``make_host_mesh()``'s 1 x 1 (a train shape splits each
    device's rows into ``microbatches``)."""
    t0 = time.perf_counter()
    params = abstract_params(cfg)
    args_b, out_b = spec_bytes(cfg, shape, mesh, params)
    rows = _rows(mesh, cfg, shape)
    n_mb = 1
    if shape.kind == "train":
        # a device with fewer rows than microbatches runs one row each
        per_mb = max(1, rows // microbatches)
        n_mb = -(-rows // per_mb)
        rows = per_mb
    n_units = stack_plan(cfg)[2]
    if shape.kind == "decode" or n_units <= 3:
        tr = trace_step(cfg, shape, rows, microbatches=n_mb, params=params)
        flops, temp = tr["flops"], tr["peak_bytes"] - tr["args_bytes"]
        units_traced: Any = "all"
        trace_s = tr["seconds"]
    else:
        two, three = (trace_step(cfg, shape, rows, units=u,
                                 microbatches=n_mb, params=params)
                      for u in (2, 3))
        flops = _extrapolate(two["flops"], three["flops"], n_units)
        temp = max(_extrapolate(a - two["args_bytes"],
                                b - three["args_bytes"], n_units)
                   for a, b in zip(two["peaks"], three["peaks"]))
        units_traced = [2, 3]
        trace_s = two["seconds"] + three["seconds"]
    flops = flops * n_mb / mesh.shape.get("model", 1)
    rec = {
        "arch": cfg.name, "shape": shape.name, "mesh": _mesh_name(mesh),
        "status": "ok",
        "lower_s": round(time.perf_counter() - t0, 1), "compile_s": None,
        "flops": float(flops),
        "bytes_accessed": None,
        "per_device": {
            "argument_bytes": args_b,
            "output_bytes": out_b,
            "temp_bytes": int(temp),
            "peak_bytes": args_b + int(temp),
        },
        "collective_bytes": {},
        "trace": {"rows": rows, "microbatches": n_mb,
                  "units": units_traced, "n_units": n_units,
                  "seconds": round(trace_s, 1)},
        "notes": [NOTES],
    }
    if verbose:
        pd = rec["per_device"]
        print(f"  [{rec['mesh']}] {cfg.name} x {shape.name}: "
              f"flops={rec['flops']:.3e} "
              f"args={_fmt_bytes(pd['argument_bytes'])} "
              f"temp={_fmt_bytes(pd['temp_bytes'])} "
              f"peak={_fmt_bytes(pd['peak_bytes'])} "
              f"(trace {trace_s:.1f}s, units {units_traced})", flush=True)
    return rec


def real_step(cfg, shape, *, microbatches: int = 1, steps: int = 4,
              seed: int = 0) -> Dict[str, Any]:
    """The check of a record against the card: ``cfg``'s bf16 parameters
    (from ``seed``) built on the card (the port's default engine) with
    what the step of ``shape`` takes, then ``steps`` real steps, the
    first a warm-up. Decode: the decode states, ``token`` and
    ``position`` and greedy steps through ``make_serve_step``. Train:
    AdamW's float32 state, a batch of random tokens, and steps of
    ``make_train_step`` over ``microbatches`` with remat, the parameters
    bf16 as the record takes them.

    Returns ``argument_bytes`` (the bytes of those tensors),
    ``peak_bytes`` (``torch.cuda.max_memory_allocated`` over every step
    above what the device held before the tensors were built),
    ``temp_bytes`` (the most a step after the warm-up allocated above
    what was live when it started: what the warm-up leaves held, such as
    cuBLAS's workspace, is not the step's), ``ms`` (the median of the
    steps after the first, by CUDA events), ``step_ms`` (each step's)
    and ``outputs`` (each step's next tokens, or ``[loss]``)."""
    if steps < 2:
        raise ValueError(f"steps must be >= 2 (a warm-up, then the "
                         f"measured), got {steps}")
    if shape.kind not in ("decode", "train"):
        raise ValueError(f"{shape.name} is a {shape.kind} shape; the card "
                         f"check runs decode and train cells")
    model = build_model(cfg, remat=shape.kind == "train")
    dev = model.device
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    b = shape.global_batch
    if shape.kind == "decode":
        params = model.init(seed, torch.bfloat16)
        states = model.init_decode_state(b, shape.seq_len, torch.bfloat16)
        token = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        position = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        held = (params, states, token, position)
        serve, _ = make_serve_step(model)

        def run(i: int):
            nonlocal states, token
            token, states = serve(params, states, token, position + i)
            return token
    else:
        train, init_fn, _ = make_train_step(model, AdamWConfig(),
                                            microbatches=microbatches)
        params, opt, _ = init_fn(seed, torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                                  generator=gen, dtype=v.dtype, device=dev)
                 if v.dtype == torch.int32 else
                 torch.randn(tuple(v.shape), generator=gen, device=dev
                             ).to(v.dtype)
                 for k, v in input_specs(cfg, shape).items()}
        held = (params, opt, batch)

        def run(i: int):
            nonlocal params, opt
            params, opt, _, metrics = train(params, opt, None, batch)
            return metrics["loss"]
    allocated = sum(x.numel() * x.element_size() for x in tree_leaves(held))
    del held
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times, outputs = [], []
    peak = before = 0
    for i in range(steps):
        if i == 1:
            peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = run(i)
        ev1.record()
        torch.cuda.synchronize(dev)
        times.append(ev0.elapsed_time(ev1))
        outputs.append(out.flatten().tolist())
    high = torch.cuda.max_memory_allocated(dev)
    return {"argument_bytes": allocated,
            "peak_bytes": max(peak, high) - base,
            "temp_bytes": high - before,
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
                rec = lower_cell(arch, shp, multi_pod=mp)
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
