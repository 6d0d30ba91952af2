"""Training launcher of the port, on the H100.

  python -m repro_torch.launch.train --arch qwen3-8b \
      --override '{"n_layers": 12}' --steps 6 --seq-len 256 \
      --global-batch 8 --microbatches 2

On the host, through the plain PyTorch path::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --smoke --pim-backend torch:device=cpu --steps 4

Sharded, one process a rank under ``torch.distributed.run`` (here two
ranks on one card, which share it through gloo)::

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-8b \
      --smoke --model-parallel 2 --dist-backend gloo

Wires together: config registry -> model (``remat=True``) on the
engine's device -> host mesh -> train step (microbatching, optional
int8 error-feedback gradient compression, AdamW in place) ->
deterministic data pipeline -> checkpointing -> the retrying runner
(``--ckpt-dir``). The port's copy of ``repro.launch.train``, with the
serve launcher's ``--pim-backend``: without it the model lives on the
port's default engine, on the card, and the launcher raises when CUDA is
absent (it never falls back to the host).

Under ``torch.distributed.run`` (``WORLD_SIZE`` in the environment) the
launcher starts a process group with ``--dist-backend`` (default
``nccl`` on the card, ``gloo`` with a CPU ``--pim-backend``; never
switched after a failure), lays the ranks out as a (data,
``--model-parallel``) mesh and trains sharded (tensor parallel over
``model``, data parallel with ZeRO-1 over ``data``; see
:mod:`repro_torch.train.step`). Each rank's card is ``cuda:LOCAL_RANK %
device_count``: on one card every rank shares ``cuda:0``, which needs
gloo. Every rank draws the whole batch and takes its rows. Only rank 0
logs (others log warnings only) and writes the log file, the trace, the
metrics and ``--summary``; checkpoints are gathered and rank 0 writes
them.

Without ``--ckpt-dir`` each step runs under the span ``train.step`` and
lands in the histogram ``train.step_ms``; the gauge
``train.tokens_per_sec`` is the tokens of a step over the mean step
time. ``--trace`` and ``--metrics`` write them.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import dist, obs
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.engine import Engine
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.model import abstract_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import (RetryingRunner, make_train_step,
                               restore_checkpoint)
from repro_torch.train.sharding import train_state_specs
from repro_torch.tree import tree_leaves

__all__ = ["TrainRun", "main"]

# No logging side effects at import time: handlers attach only when
# main() calls obs.setup_logging() (see repro_torch.obs.logging).
log = obs.get_logger("train")


@dataclass
class TrainRun:
    """What a launcher run did: the step it started from, each step's
    loss, grad norm, learning rate and wall seconds (without
    ``--ckpt-dir``; with it, the runner's last loss only), the tokens of
    a step, the runner's metrics (``restarts``, ``straggler_events``),
    the final state (this rank's shards), the mesh's axis sizes, and for
    each rank (in rank order) the bytes of its placed parameters and
    AdamW state (``m``, ``v``, the count: what the dry-run's
    ``spec_bytes`` counts; the residual is not included) and, on the
    card, its peak allocated bytes."""

    start: int
    losses: List[float]
    step_s: List[float]
    tokens_per_step: int
    runner: Dict = field(default_factory=dict)
    state: tuple = ()
    grad_norms: List[float] = field(default_factory=list)
    lrs: List[float] = field(default_factory=list)
    mesh: Dict[str, int] = field(default_factory=dict)
    placed_bytes: List[int] = field(default_factory=list)
    peak_bytes: List[int] = field(default_factory=list)

    def summary(self) -> Dict:
        """The numbers of the run (no state), for ``--summary``."""
        return {"start": self.start, "losses": self.losses,
                "grad_norms": self.grad_norms, "lrs": self.lrs,
                "step_s": self.step_s,
                "tokens_per_step": self.tokens_per_step,
                "runner": self.runner, "mesh": self.mesh,
                "placed_bytes": self.placed_bytes,
                "peak_bytes": self.peak_bytes}


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    """Parse the flags (``argv``, default ``sys.argv[1:]``) and train;
    returns the :class:`TrainRun`."""
    ap = argparse.ArgumentParser(
        description="Training launcher on the port's engine (on the card "
                    "unless --pim-backend says otherwise).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-parallel width: the mesh is (world / N, "
                         "N) over the ranks of torch.distributed.run")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="process-group backend under "
                         "torch.distributed.run: nccl (a card a rank; the "
                         "default on the card) or gloo (the CPU, or ranks "
                         "sharing one card; the default with a CPU "
                         "--pim-backend)")
    ap.add_argument("--summary", default=None, metavar="OUT.json",
                    help="write the run's numbers (losses, grad norms, "
                         "lr, step seconds, mesh, each rank's placed and "
                         "peak bytes) as JSON")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-file", default="")
    ap.add_argument("--override", default="",
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--pim-backend", default=None,
                    help="execution backend spec for the engine the model "
                         "lives on, e.g. 'torch:device=cpu' (the host); "
                         "default: the port's engine on CUDA")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable span tracing and write a Chrome "
                         "trace-event file at exit")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="write the obs metrics snapshot as JSON")
    args = ap.parse_args(argv)
    on_cpu = "device=cpu" in (args.pim_backend or "")
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_distributed(args.dist_backend
                              or ("gloo" if on_cpu else "nccl"))
    lead = dist.rank() == 0
    obs.setup_logging(logging.INFO if lead else logging.WARNING)
    if args.trace and lead:
        obs.enable()
    try:
        mesh = make_host_mesh(args.model_parallel)
    except ValueError as e:
        raise SystemExit(f"--model-parallel {args.model_parallel}: {e}; "
                         f"run one process a rank under python -m "
                         f"torch.distributed.run") from None

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.override:
        cfg = cfg.scaled(**json.loads(args.override))
    if dist.is_initialized() and not on_cpu and torch.cuda.is_available():
        torch.cuda.set_device(dist.local_device("cuda"))
    # No --pim-backend: the port's default engine on CUDA (it raises
    # without a card rather than training on the host).
    engine = Engine(args.pim_backend)
    model = build_model(cfg, remat=True, engine=engine)
    log.info("arch=%s params~%.1fM mesh=%s device=%s", cfg.name,
             cfg.param_count() / 1e6, mesh.shape, model.device)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps)
    step_fn, init_fn, jit_for = make_train_step(
        model, opt_cfg, mesh, microbatches=args.microbatches,
        compress_grads=args.compress_grads)

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = (cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        extra["frames"] = (cfg.enc_frames, cfg.d_model)
    raw_batch_fn = make_batch_fn(dc, extra)

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(model.device)
                for k, v in raw_batch_fn(step).items()}

    params, opt_state, resid = init_fn(0)
    ps, os_, _ = train_state_specs(mesh, abstract_params(cfg))
    ckpt_specs = {"params": ps, "opt": os_}
    start = 0
    if args.ckpt_dir:
        runner = RetryingRunner(step_fn=None, batch_fn=batch_fn,
                                ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every, mesh=mesh,
                                specs=ckpt_specs)
        last = runner.latest()
        if last is not None:
            restored, start = restore_checkpoint(
                args.ckpt_dir, {"params": params, "opt": opt_state},
                step=last, mesh=mesh, specs=ckpt_specs)
            params, opt_state = restored["params"], restored["opt"]
            log.info("resumed from step %d", start)

    jit_step = jit_for(params, batch_fn(start))
    tokens_per_step = args.global_batch * args.seq_len
    run = TrainRun(start=start, losses=[], step_s=[],
                   tokens_per_step=tokens_per_step, mesh=mesh.shape)

    logf = open(args.log_file, "a") if args.log_file and lead else None
    try:
        if args.ckpt_dir:
            runner.step_fn = jit_step
            t0 = time.time()
            (params, opt_state, resid), run.runner = runner.run(
                (params, opt_state, resid), start, args.steps - start)
            if "loss" in run.runner:
                run.losses.append(run.runner["loss"])
            log.info("done: %s (%.1fs)", run.runner, time.time() - t0)
        else:
            step_ms = obs.histogram("train.step_ms")
            for step in range(start, args.steps):
                t0 = time.time()
                with obs.span("train.step", step=step):
                    params, opt_state, resid, met = jit_step(
                        params, opt_state, resid, batch_fn(step))
                    loss = float(met["loss"])     # waits for the card
                dt = time.time() - t0
                step_ms.observe(dt * 1e3)
                run.losses.append(loss)
                run.grad_norms.append(float(met["grad_norm"]))
                run.lrs.append(float(met["lr"]))
                run.step_s.append(dt)
                if step % 10 == 0 or step == args.steps - 1:
                    log.info("step %5d loss %.4f  %.2fs/step  %.0f tok/s",
                             step, loss, dt, tokens_per_step / dt)
                if logf:
                    logf.write(f"{step},{loss:.5f},{dt:.3f}\n")
                    logf.flush()
            obs.gauge("train.tokens_per_sec").set(
                tokens_per_step / max(step_ms.mean / 1e3, 1e-9)
                if step_ms.count else 0.0)
    finally:
        if logf:
            logf.close()
    run.state = (params, opt_state, resid)
    world = (torch.distributed.group.WORLD if dist.world_size() > 1
             else None)
    run.placed_bytes = dist.all_gather_ints(
        _tree_bytes(params) + _tree_bytes(opt_state), world)
    if model.device.type == "cuda":
        run.peak_bytes = dist.all_gather_ints(
            torch.cuda.max_memory_allocated(model.device), world)
    if not lead:
        return run
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(run.summary(), f)
    if args.trace:
        n_ev = obs.export_trace(args.trace)
        log.info("trace: %d events -> %s", n_ev, args.trace)
    if args.metrics:
        obs.write_metrics(args.metrics)
        log.info("metrics snapshot -> %s", args.metrics)
    return run


if __name__ == "__main__":
    main(sys.argv[1:])
