"""Elastic restart across mesh shapes, one process a rank.

The schedule of the reference's ``tests/test_elastic_multidevice.py`` as
an entry point of the port::

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.launch.elastic --arch deepseek-7b \\
      --smoke --pim-backend torch:device=cpu --model-parallel 2 \\
      --survivors 4 --ckpt-dir /tmp/elastic --out elastic.json

Every rank first trains ``--steps`` + ``--more`` steps without a break on
the (world / N, N) mesh (``r1``, ``r2``). Then, from the same start, it
trains ``--steps`` steps on that mesh (``l1``) and checkpoints (gathered;
rank 0 writes the mesh-agnostic format). The ranks past ``--survivors``
leave; the survivors re-mesh with
:func:`repro_torch.train.fault.elastic_remesh` (their own process
groups), restore the checkpoint sharded for the new mesh and train
``--more`` steps (``l2``), which must continue the uninterrupted run's
``r2``. The stream, the model (no remat) and AdamW (lr 2e-3, warmup 1,
50 steps) are the reference test's.

``--init-ckpt DIR`` starts from the parameters of a checkpoint (the
reference's ``init_fn(PRNGKey(0))`` for a check across packages) instead
of ``--seed``. Rank 0 writes ``{"l1", "l2", "r1", "r2", "mesh1",
"mesh2"}`` to ``--out``. The default engine is the card's, and the
default backend gloo (ranks that share a card).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

import torch

from repro_torch import dist
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.engine import Engine
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.model import abstract_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import (make_train_step, restore_checkpoint,
                               save_checkpoint)
from repro_torch.train.fault import elastic_remesh
from repro_torch.train.sharding import train_state_specs

__all__ = ["run_schedule", "main"]

OPT = AdamWConfig(lr=2e-3, warmup_steps=1, total_steps=50)


def _specs(mesh, cfg):
    ps, os_, _ = train_state_specs(mesh, abstract_params(cfg))
    return {"params": ps, "opt": os_}


def _start(model, mesh, seed: int, init_ckpt: Optional[str]):
    step, init_fn, _ = make_train_step(model, OPT, mesh)
    params, opt, _ = init_fn(seed)
    if init_ckpt:
        back, _ = restore_checkpoint(init_ckpt, {"params": params,
                                                 "opt": opt},
                                     mesh=mesh, specs=_specs(mesh,
                                                             model.cfg))
        params, opt = back["params"], back["opt"]
    return step, params, opt


def _steps(step, params, opt, batch_fn, start: int, n: int):
    losses = []
    for s in range(start, start + n):
        params, opt, _, met = step(params, opt, None, batch_fn(s))
        losses.append(float(met["loss"]))
    return params, opt, losses


def run_schedule(model, *, model_parallel: int, survivors: int,
                 steps: int, more: int, ckpt_dir: str, seed: int = 0,
                 init_ckpt: Optional[str] = None) -> Optional[Dict]:
    """The schedule of the module docstring on this rank (every rank of
    the running process group calls it). Returns the losses and meshes
    on the survivors, None on a rank that leaves."""
    cfg = model.cfg
    raw = make_batch_fn(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=8))

    def batch_fn(s):
        return {k: torch.from_numpy(v).to(model.device)
                for k, v in raw(s).items()}

    mesh1 = make_host_mesh(model_parallel)
    step, params, opt = _start(model, mesh1, seed, init_ckpt)
    params, opt, r1 = _steps(step, params, opt, batch_fn, 0, steps)
    params, opt, r2 = _steps(step, params, opt, batch_fn, steps, more)

    step, params, opt = _start(model, mesh1, seed, init_ckpt)
    params, opt, l1 = _steps(step, params, opt, batch_fn, 0, steps)
    save_checkpoint(ckpt_dir, steps, {"params": params, "opt": opt},
                    mesh=mesh1, specs=_specs(mesh1, cfg))
    del params, opt
    if dist.rank() >= survivors:
        return None                       # this rank is lost

    mesh2 = elastic_remesh(list(range(survivors)), model_parallel)
    step2, like_p, like_o = _start(model, mesh2, seed, None)
    back, step0 = restore_checkpoint(ckpt_dir, {"params": like_p,
                                                "opt": like_o},
                                     mesh=mesh2, specs=_specs(mesh2, cfg))
    del like_p, like_o
    _, _, l2 = _steps(step2, back["params"], back["opt"], batch_fn, step0,
                      more)
    return {"l1": l1, "l2": l2, "r1": r1, "r2": r2, "mesh1": mesh1.shape,
            "mesh2": mesh2.shape, "restored_step": step0}


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict]:
    """Parse the flags, start the process group and run the schedule;
    rank 0 writes ``--out``. Returns this rank's result."""
    ap = argparse.ArgumentParser(
        description="Elastic restart across mesh shapes under "
                    "torch.distributed.run.")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--survivors", type=int, required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--more", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-ckpt", default=None)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pim-backend", default=None)
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default="gloo")
    args = ap.parse_args(argv)
    if not dist.is_initialized():
        dist.init_distributed(args.dist_backend)
    on_cpu = "device=cpu" in (args.pim_backend or "")
    if not on_cpu and torch.cuda.is_available():
        torch.cuda.set_device(dist.local_device("cuda"))
    model = build_model(get_config(args.arch, smoke=args.smoke),
                        engine=Engine(args.pim_backend))
    out = run_schedule(model, model_parallel=args.model_parallel,
                       survivors=args.survivors, steps=args.steps,
                       more=args.more, ckpt_dir=args.ckpt_dir,
                       seed=args.seed, init_ckpt=args.init_ckpt)
    if dist.rank() == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
