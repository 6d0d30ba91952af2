"""What the retrying runner's fault fence costs a fault-free sharded step.

qwen3-8b at its published width cut to 2 layers, 4 x 1,024 tokens a step
in 2 microbatches, float32 (the shapes of ``chip_smoke.py``'s
``train_sharded`` phase), on the (data, model) meshes (1, 2) and (2, 1)
over two gloo ranks: after a warm-up step, the same jitted step timed
without a ``repro_torch.dist.Fence`` and under one, three times in the
order off, on, on, off (the state carried on, so each step is a real
training step), each with its loss, its seconds on the host's clock (the
loss read, so the card is done) and this rank's collective bytes by
kind. Rank 0 prints one JSON line: per mesh, each step's fence state,
seconds, loss and bytes, and the median seconds with and without the
fence. On the card (two ranks sharing it)::

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 scripts/fence_cost.py

``--device cpu --smoke`` runs the same on the host at smoke size.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

ORDER = (False, True, True, False) * 3    # fence off, on, on, off
MESHES = (2, 1)             # model_parallel: (1, 2), then (2, 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    dist.init_distributed("gloo")
    on_card = args.device == "cuda"
    dev = dist.local_device(args.device)
    if on_card:
        torch.cuda.set_device(dev)
    cfg = get_config("qwen3-8b", smoke=args.smoke)
    if not args.smoke:
        cfg = cfg.scaled(n_layers=2)
    model = build_model(cfg, remat=True, engine=Engine(
        None if on_card else "torch:device=cpu"))
    raw = make_batch_fn(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                                   global_batch=4))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "tokens": 4 * 1024,
           "microbatches": 2, "order": list(ORDER), "meshes": {}}
    try:
        for tp in MESHES:
            mesh = make_host_mesh(tp)
            _, init_fn, jit_for = make_train_step(
                model, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=50),
                mesh, microbatches=2)

            def batch(s):
                return {k: torch.from_numpy(v).to(dev)
                        for k, v in raw(s).items()}
            state = init_fn(0)
            jit = jit_for(state[0], batch(0))
            *state, met = jit(*state, batch(0))        # warm-up
            float(met["loss"])
            steps = []
            for s, fenced in enumerate(ORDER, start=1):
                fence = dist.Fence(mesh.comm.ranks)
                dist.reset_collective_bytes()
                t0 = time.perf_counter()
                if fenced:
                    with fence:
                        *state, met = jit(*state, batch(s))
                        loss = float(met["loss"])
                else:
                    *state, met = jit(*state, batch(s))
                    loss = float(met["loss"])
                steps.append({"fence": fenced,
                              "s": time.perf_counter() - t0, "loss": loss,
                              "bytes": dist.collective_bytes()})
            med = {k: statistics.median(x["s"] for x in steps
                                        if x["fence"] == on)
                   for k, on in (("on_s", True), ("off_s", False))}
            out["meshes"][f"{mesh.shape['data']}x{mesh.shape['model']}"] = {
                "steps": steps, **med, "ratio": med["on_s"] / med["off_s"]}
            del state, met, jit
            if on_card:
                torch.cuda.empty_cache()
        if dist.rank() == 0:
            print(json.dumps(out), flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
