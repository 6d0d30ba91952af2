"""Serving launcher of the port: model-mode prefill and greedy decode, and
continuous-batching traffic, on the H100.

Model mode (the default) builds a model zoo architecture (``--arch``,
default gemma2-9b at its published width; ``--smoke`` for the reduced
config), draws its parameters from seed 0 on the engine's device, runs a
batched prefill over seeded prompts and a greedy decode loop
(:func:`serve_model`), and logs prefill seconds, decode tokens/s and the
per-token latency percentiles. With ``--pim`` (on by default under
``--smoke``) the LM head runs as a PIM-mode linear through the port's
:class:`~repro_torch.engine.Engine`; ``--pim-scope ffn|full`` adds the FFN
and then the attention q/k/v/o projections, lowered by
:func:`repro_torch.pim.plan_block` onto co-scheduled crossbar groups that
compile once: a recompile during decode fails the run. ``--trace``
writes the run's spans: the prefill and each decode step
(``serve.prefill``, ``serve.decode_step``), the model's own
(``model.forward``, ``model.decode_step``) and, under them, each PIM
projection (``pim.linear``) with its phases (``pim.weight``,
``pim.activation``, ``pim.product``, ``pim.dequant``), and merges the
groups' modeled-cycle waterfalls into the trace, from where its spans
start. (Device time per span comes only under ``torch.profiler``; see
:mod:`repro_torch.obs.trace`.) On the card::

  python -m repro_torch.launch.serve --arch gemma2-9b --pim \
      --pim-scope full --trace /tmp/t.json

On the host, through the kernels' plain PyTorch versions::

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --pim-backend torch:device=cpu,pack=true

Traffic mode (``--traffic N``) runs the :mod:`repro_torch.serve`
continuous-batching scheduler against a seeded Poisson trace of N
generate requests — admission control, device-resident lanes (or
dynamic-K grouped passes on the round-trip path), SLO percentiles from
:mod:`repro_torch.obs`. With ``--traffic-compare`` the same trace
replays under per-pass host round-trip and serial one-request-at-a-time
scheduling and the launcher reports both speedups;
``--traffic-check X`` turns the serial ratio into a hard gate and
``--traffic-resident-check X`` gates the continuous-over-roundtrip
ratio (both also require zero recompiles after warmup and bit-identical
tokens across schedules). ``--fault-rate P`` injects seeded transient
bit flips (``faults=flip@P@SEED`` in the backend spec) and
``--fault-check`` gates the run bit-exact under them::

  python -m repro_torch.launch.serve --traffic 32 --traffic-rate 500 \
      --fault-rate 1e-5 --fault-check

Without ``--pim-backend`` either mode runs on the port's default engine,
packed torch on CUDA, and raises when there is no card.

Model mode serves sharded under ``torch.distributed.run`` (``WORLD_SIZE``
in the environment): the launcher starts a process group with
``--dist-backend`` (default ``nccl`` on the card, ``gloo`` with a CPU
``--pim-backend``), lays the ranks out as a (data, ``--model-parallel``)
mesh, draws each rank's shards of the parameters and of the decode
states (``state_shardings``: KV heads, or the cache's slots where the KV
heads do not split), and runs prefill and the greedy decode loop over
the mesh (:func:`repro_torch.train.make_serve_step`), the PIM scales
taken over the whole tensors. Two ranks sharing one card need gloo::

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.serve --arch gemma2-9b \
      --pim --pim-scope full --model-parallel 2 --dist-backend gloo

Every rank plans the PIM scopes and gates compile-once (the run fails if
any rank recompiled during decode); only rank 0 logs at INFO, traces
and writes ``--trace``, ``--metrics`` and ``--summary``. Traffic mode serves on one rank, as the reference's does.

The port's copy of ``repro.launch.serve``. The reference's deprecated
``--pim-k`` (pin the batch width) is dropped: ``--traffic-slots`` clamps
the slot budget, and K is load-driven.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import dist, obs
from repro_torch.configs import get_config
from repro_torch.device import (CoordAllocator, DeviceConfig, block_trace,
                                charge)
from repro_torch.engine import Engine
from repro_torch.faults import get_fault_model
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import encode
from repro_torch.pim import plan_block, plan_serve_slots
from repro_torch.serve import (DECODE_ELEMS, TrafficConfig, compare_modes,
                               generate, run_load)
from repro_torch.train import make_serve_step
from repro_torch.train.step import batch_rows, gather_rows, greedy_token
from repro_torch.tree import tree_leaves

# No logging side effects at import time: handlers attach only when
# main() calls obs.setup_logging() (see repro_torch.obs.logging).
log = obs.get_logger("serve")


def _log_report(rep) -> None:
    s = rep.summary()
    log.info("[%s] %d requests, %d tokens in %.3fs -> %.1f tok/s | "
             "%d passes, recompiles=%d, bit_exact=%s",
             rep.mode, s["n_requests"], s["n_tokens"], s["wall_s"],
             s["tokens_per_s"], s["passes"], s["recompiles"],
             s["bit_exact"])
    log.info("[%s] steady-state: TTFT p50=%.0fus p99=%.0fus | "
             "token latency p50=%.0fus p99=%.0fus",
             rep.mode, s["ttft_p50_us"], s["ttft_p99_us"],
             s["token_p50_us"], s["token_p99_us"])


def _run_traffic(args):
    """--traffic mode: continuous-batching load run, no model build.
    Returns the continuous run's :class:`~repro_torch.serve.LoadReport`."""
    fault_spec = None
    if args.fault_rate is not None:
        # Compose the fault model into the backend spec so the packed
        # executors inject at the device layer; seed it explicitly so a
        # rerun replays the identical fault sequence.
        fault_spec = f"flip@{args.fault_rate:g}@{args.fault_seed}"
        base = args.pim_backend or "torch"
        sep = "," if ":" in base else ":"
        args.pim_backend = f"{base}{sep}faults={fault_spec}"
        get_fault_model(fault_spec).reset()
        log.info("fault injection: %s (backend %s)", fault_spec,
                 args.pim_backend)
    # No --pim-backend: the port's default engine, packed torch on CUDA
    # (it raises without a card rather than serving from the host).
    engine = Engine(args.pim_backend)
    log.info("engine backend: %s", engine.backend)
    n = args.pim_bits
    elems = args.traffic_elems or DECODE_ELEMS
    device = None
    if args.device_config is not None:
        device = DeviceConfig.parse(args.device_config,
                                    crossbar=engine.crossbar)
        log.info("device hierarchy: %s (%d crossbars)", device,
                 device.n_crossbars)
    # The slot budget comes from the crossbar column budget via the
    # planner (scaled by the device crossbar count under --device-config),
    # clamped by --traffic-slots.
    max_slots = args.traffic_slots
    slots = plan_serve_slots(engine, n, max_slots=max_slots, device=device)
    log.info("%s", slots.summary())
    if max_slots is None and device is not None:
        max_slots = slots.max_slots    # device-scaled budget -> scheduler

    cfg = TrafficConfig(n_requests=args.traffic, rate=args.traffic_rate,
                        n_bits=n, seed=args.traffic_seed)
    reqs = generate(cfg)
    log.info("trace: %d requests over %.3fs (Poisson %.0f req/s, seed %d)",
             len(reqs), reqs[-1].arrival if reqs else 0.0,
             args.traffic_rate, args.traffic_seed)

    common = dict(n_bits=n, decode_elems=elems, max_slots=max_slots,
                  priority=args.traffic_priority)
    gating = (args.traffic_check is not None
              or args.traffic_resident_check is not None)
    if (fault_spec is not None or args.fault_check
            or args.watchdog is not None):
        # Fault/watchdog mode is a single continuous run: replaying the
        # trace under other schedules would advance the shared fault
        # model's pass counter, so cross-mode parity is not meaningful
        # under injection — the bit-exactness check is against the
        # plain-int reference tokens instead.
        cont = run_load(engine, reqs, mode="continuous",
                        watchdog_s=args.watchdog, **common)
        _log_report(cont)
        c = obs.dump()["counters"]
        log.info("faults: injected=%d detected=%d (+%d residue) "
                 "recovered=%d unrecovered=%d escaped=%d | restarts=%d "
                 "quarantined=%d displaced=%d rejected=%d",
                 c.get("faults.injected", 0), c.get("faults.detected", 0),
                 c.get("faults.detected_residue", 0),
                 c.get("faults.recovered", 0),
                 c.get("faults.unrecovered", 0),
                 c.get("faults.escaped", 0),
                 c.get("serve.fault.restarts", 0),
                 c.get("serve.fault.quarantined", 0),
                 c.get("serve.fault.displaced", 0),
                 c.get("serve.rejected", 0))
        if args.fault_check:
            fails = []
            if not cont.bit_exact:
                fails.append(f"{cont.escaped_tokens} corrupt token(s) "
                             f"escaped detection")
            if cont.recompiles != 0:
                fails.append(f"recompiles after warmup = {cont.recompiles}"
                             f" (recovery must not recompile)")
            if cont.aborted:
                fails.append("watchdog aborted the run")
            if fails:
                raise SystemExit("fault gate FAILED: " + "; ".join(fails))
            log.info("fault gate passed: bit-exact under %s, zero "
                     "recompiles, no abort",
                     fault_spec or "fault-free serving")
    elif args.traffic_compare or gating:
        res = compare_modes(engine, reqs, **common)
        cont, rt, ser = res["continuous"], res["roundtrip"], res["serial"]
        _log_report(cont)
        _log_report(rt)
        _log_report(ser)
        log.info("continuous batching speedup: %.2fx over serial, "
                 "%.2fx over per-pass round-trip (tokens_match=%s)",
                 res["speedup"], res["resident_speedup"],
                 res["tokens_match"])
        obs.gauge("serve.load.speedup").set(res["speedup"])
        obs.gauge("serve.load.resident_speedup").set(
            res["resident_speedup"])
        if gating:
            fails = []
            if (args.traffic_check is not None
                    and res["speedup"] < args.traffic_check):
                fails.append(f"speedup {res['speedup']:.2f}x < "
                             f"{args.traffic_check:.2f}x over serial")
            if (args.traffic_resident_check is not None
                    and res["resident_speedup"]
                    < args.traffic_resident_check):
                fails.append(
                    f"resident speedup {res['resident_speedup']:.2f}x < "
                    f"{args.traffic_resident_check:.2f}x over round-trip")
            if cont.recompiles != 0:
                fails.append(f"recompiles after warmup = {cont.recompiles}")
            if not res["tokens_match"]:
                fails.append("token mismatch between schedules")
            if fails:
                raise SystemExit("serve load gate FAILED: "
                                 + "; ".join(fails))
            log.info("serve load gate passed: %.2fx over serial, %.2fx "
                     "over round-trip, zero recompiles, bit-exact",
                     res["speedup"], res["resident_speedup"])
    else:
        cont = run_load(engine, reqs, mode="continuous", **common)
        _log_report(cont)
    obs.gauge("serve.load.tokens_per_s").set(cont.tokens_per_s)
    obs.gauge("serve.load.ttft_p99_us").set(
        cont.ttft_us.get("p99", 0.0))
    obs.gauge("serve.load.token_p99_us").set(
        cont.token_latency_us.get("p99", 0.0))

    if args.trace:
        n_ev = obs.export_trace(args.trace)
        log.info("trace: %d events -> %s", n_ev, args.trace)
    if args.metrics:
        obs.write_metrics(args.metrics)
        log.info("metrics snapshot -> %s", args.metrics)
    return cont


# ------------------------------------------------------------ model mode ----
@dataclass
class GreedyRun:
    """What :func:`serve_model` generated and what it cost.

    ``tokens`` (B, gen) int32 on the host: the prefill's greedy token,
    then one per decode step. ``stats_before``/``stats_after`` are
    ``engine.stats()`` around the decode loop (the compile-once gate
    reads their ``compiles``); ``token_latency_us`` holds one host-clock
    sample per decode step, each ending in a read of the step's token
    (which waits for the card). ``mesh``: the mesh's axis sizes; then,
    for each rank of it in rank order, the bytes of its placed
    parameters and decode states (what the dry-run's ``spec_bytes``
    counts for them), its peak allocated bytes on the card (empty on the
    CPU) and its programs compiled during decode."""

    tokens: np.ndarray
    prefill_s: float
    decode_s: float
    token_latency_us: List[float]
    stats_before: Dict[str, int]
    stats_after: Dict[str, int]
    mesh: Dict[str, int] = field(default_factory=dict)
    param_bytes: List[int] = field(default_factory=list)
    state_bytes: List[int] = field(default_factory=list)
    peak_bytes: List[int] = field(default_factory=list)
    rank_recompiles: List[int] = field(default_factory=list)

    @property
    def recompiles(self) -> int:
        """Programs compiled during the decode loop (0 when the PIM
        schedules compiled once, before it)."""
        return self.stats_after["compiles"] - self.stats_before["compiles"]

    @property
    def tokens_per_s(self) -> float:
        """Decode tokens per second per sequence."""
        steps = self.tokens.shape[1] - 1
        return steps / max(self.decode_s, 1e-9)

    def latency_us(self, q: float) -> float:
        """Decode-step latency percentile ``q`` in [0, 100] (0 without a
        decode step)."""
        if not self.token_latency_us:
            return 0.0
        return float(np.percentile(self.token_latency_us, q))

    def summary(self) -> Dict:
        """The run's numbers, for ``--summary``."""
        return {"tokens": self.tokens.tolist(), "prefill_s": self.prefill_s,
                "decode_s": self.decode_s,
                "tokens_per_s": self.tokens_per_s,
                "token_p50_us": self.latency_us(50),
                "token_p99_us": self.latency_us(99), "mesh": self.mesh,
                "param_bytes": self.param_bytes,
                "state_bytes": self.state_bytes,
                "peak_bytes": self.peak_bytes,
                "rank_recompiles": self.rank_recompiles}


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def serve_model(model, params, prompts: torch.Tensor, engine, *, gen: int,
                cache_len: int, frames: Optional[torch.Tensor] = None,
                mesh=None) -> GreedyRun:
    """Prefill ``prompts`` (B, S) through ``model`` on ``params``, leaving
    the KV caches and recurrent states behind, then decode greedily until
    each sequence has ``gen`` tokens. ``frames`` (B, F, D) feed the
    enc-dec encoder. ``engine`` is the model's engine; its cache counters
    are read around the decode loop.

    Prefill is ``model.forward`` with states; decode is
    :func:`repro_torch.train.make_serve_step`'s step, as in the
    reference's launcher. Spans ``serve.prefill`` and
    ``serve.decode_step``; every step's latency is in the run's
    ``token_latency_us``.

    With a ``mesh`` of ranks every rank of it calls this with the whole
    ``prompts`` (and ``frames``) and this rank's shards of ``params``;
    each runs its rows on its shards of the decode states, and every
    rank gets the whole tokens. The bytes, peaks and recompiles of the
    returned run are gathered from every rank of the mesh.
    """
    cfg = model.cfg
    b, s = prompts.shape
    rows, dp = batch_rows(mesh, b)
    states = model.init_decode_state(b, cache_len, mesh=mesh)
    placed = _tree_bytes(states)
    if frames is not None:
        states["enc_out"] = encode(cfg, params, rows(frames), engine=engine,
                                   mesh=mesh)
    t0 = time.perf_counter()
    with obs.span("serve.prefill", batch=b, prompt_len=s):
        logits, states = model.forward(params, rows(prompts), states=states,
                                       mesh=mesh)
        tok = gather_rows(greedy_token(cfg, logits, mesh), dp)
        out = [tok.cpu().numpy()]         # waits for the card
    prefill_s = time.perf_counter() - t0
    del logits

    serve, jit_for = make_serve_step(model, mesh)
    pos0 = torch.zeros((b, 1), dtype=torch.int32, device=prompts.device)
    step = jit_for(params, states, {"token": tok, "position": pos0})
    pre = engine.stats()
    lat: List[float] = []
    t0 = time.perf_counter()
    for t in range(gen - 1):
        s0 = time.perf_counter()
        with obs.span("serve.decode_step", step=t):
            pos = pos0 + (s + t)
            tok, states = step(params, states, tok, pos)
            out.append(tok.cpu().numpy())  # device sync: real step time
        lat.append((time.perf_counter() - s0) * 1e6)
    decode_s = time.perf_counter() - t0
    run = GreedyRun(np.concatenate(out, axis=1), prefill_s, decode_s, lat,
                    pre, engine.stats())
    comm = getattr(mesh, "comm", None)
    world = None if comm is None else comm.axis(mesh.axis_names).group
    run.mesh = dict(mesh.shape) if mesh is not None else {"data": 1,
                                                          "model": 1}
    run.param_bytes = dist.all_gather_ints(_tree_bytes(params), world)
    run.state_bytes = dist.all_gather_ints(placed, world)
    run.rank_recompiles = dist.all_gather_ints(run.recompiles, world)
    if model.device.type == "cuda":
        run.peak_bytes = dist.all_gather_ints(
            torch.cuda.max_memory_allocated(model.device), world)
    return run


def _export_waterfalls(engine, plan, n_bits: int) -> None:
    """Merge modeled-cycle waterfall tracks into the trace: one process
    row per co-scheduled plan group (fused program occupancy +
    switching) and one for the LM-head MAC group. Groups placed on a
    device hierarchy (``--device-config``) carry their coordinate as a
    counter-track prefix. The tracks start where the trace's spans
    start."""
    t0 = obs.get_tracer().start_us()
    pid = 2
    seen = set()
    groups = list(plan.groups) if plan is not None else []
    for g in groups:
        gex = g.executable
        if gex is None or id(gex.program) in seen:
            continue
        seen.add(id(gex.program))
        obs.add_events(_from(t0, obs.waterfall_events(
            gex.program, packed=gex.packed,
            name=f"{g.scope}: {gex.program.name}", pid=pid,
            cycle_ns=engine.crossbar.cycle_ns,
            track=str(g.coord) if g.coord is not None else None)))
        pid += 1
    k = engine.effective_coschedule_k("mac", n_bits)
    exe = (engine.compile_batch("mac", n_bits, k) if k >= 2
           else engine.compile("mac", n_bits))
    if id(exe.program) not in seen:
        obs.add_events(_from(t0, obs.waterfall_events(
            exe.program, packed=exe.packed,
            name=f"lm_head MAC: {exe.program.name}", pid=pid,
            cycle_ns=engine.crossbar.cycle_ns)))


def _from(t0_us: float, events: List[dict]) -> List[dict]:
    """``events`` on a modeled axis from 0, moved to start at ``t0_us``."""
    for e in events:
        if "ts" in e:
            e["ts"] += t0_us
    return events


def _log_pim(args, cfg, engine, plan, device, run: GreedyRun) -> None:
    """The compile-once gate and the PIM accounting lines."""
    post = run.stats_after
    log.info("engine cache: hits=%d misses=%d disk_hits=%d entries=%d "
             "| recompiles during decode=%d",
             post["hits"], post["misses"], post["disk_hits"],
             post["entries"], run.recompiles)
    # hits >= 1 needs at least one decode step (each step's PIM linears
    # fetch the MAC group from the cache); --gen 1 runs no decode. Every
    # rank holds every rank's recompiles, so all of them stop together.
    if any(run.rank_recompiles) or (args.gen > 1 and post["hits"] < 1):
        raise SystemExit(
            f"PIM serve path violated compile-once: hits={post['hits']}"
            f" recompiles by rank={run.rank_recompiles}")
    log.info("PIM LM head: %d-bit MultPIM-MAC via the engine "
             "(backend=%s), compile-once verified",
             cfg.pim_linear_bits, engine.backend.name)
    # The co-scheduled K-MAC group the decode loop is accounted at: one
    # fused crossbar pass serves K MACs (disjoint partition ranges). A
    # MAC too wide to co-schedule (capacity < 2) stays on the plain path.
    k = engine.effective_coschedule_k("mac", cfg.pim_linear_bits)
    if k >= 2:
        cost = engine.compile_batch("mac", cfg.pim_linear_bits, k).cost()
        log.info("PIM LM head co-schedule: K=%d MACs/pass, "
                 "%d cycles/pass -> %.1f cycles/MAC (sequential: %d), "
                 "up to %.0fx fewer crossbar passes per inner product",
                 cost.programs, cost.cycles, cost.cycles_per_program,
                 cost.cycles, float(cost.programs))
    elif engine.coschedule_k < 2:
        log.info("PIM LM head co-schedule: off (requested K=%d; "
                 "sequential passes)", engine.coschedule_k)
    else:
        log.info("PIM LM head co-schedule: off (MAC width %d fills "
                 "the crossbar; sequential passes)", cfg.pim_linear_bits)
    log.info("PIM scope=%s: %d co-scheduled group(s) over scopes %s",
             args.pim_scope, len(plan.groups), list(plan.scopes))
    for scope, row in plan.scope_metrics().items():
        log.info("PIM scope [%s]: %s on %d crossbar(s) | chains=%s "
                 "-> %d MACs/pass @ %d cyc/pass = %.1f cycles/MAC | "
                 "%d passes/token, %s cycles/token (row util %.0f%%)",
                 scope, ",".join(row["linears"]), row["crossbars"],
                 row["chains"], row["macs_per_pass"], row["pass_cycles"],
                 row["cycles_per_mac"], row["passes_per_token"],
                 f"{row['cycles_per_token']:,}",
                 100 * row["row_utilization"])
    if plan.groups:
        us = plan.cycles_per_token * engine.crossbar.cycle_ns / 1e3
        log.info("PIM block plan: %s cycles/token end-to-end "
                 "(%.1f us @ %.0f ns/cycle), weight-stationary "
                 "layouts reused across all %d decode steps",
                 f"{plan.cycles_per_token:,}", us,
                 engine.crossbar.cycle_ns, args.gen - 1)
        obs.gauge("serve.cycles_per_token").set(plan.cycles_per_token)
    if device is not None and plan.groups:
        rep = charge(block_trace(plan, device))
        for line in rep.summary().splitlines():
            log.info("%s", line)
        obs.gauge("serve.device.latency_us").set(rep.latency_us)
        obs.gauge("serve.device.tokens_per_sec").set(rep.tokens_per_sec)


def _run_model(args) -> GreedyRun:
    """Model mode: build ``--arch``, plan its PIM scopes, prefill and
    decode greedily (over the mesh of ranks under a process group), gate
    compile-once. Returns the run."""
    lead = dist.rank() == 0
    mesh = None
    if dist.is_initialized():
        try:
            mesh = make_host_mesh(args.model_parallel)
        except ValueError as e:
            raise SystemExit(f"--model-parallel {args.model_parallel}: "
                             f"{e}") from None
        if ("device=cpu" not in (args.pim_backend or "")
                and torch.cuda.is_available()):
            torch.cuda.set_device(dist.local_device("cuda"))
    pim = args.smoke if args.pim is None else args.pim
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.override:
        cfg = cfg.scaled(**json.loads(args.override))
    if pim:
        block_mode = {"head": "none", "ffn": "ffn",
                      "full": "full"}[args.pim_scope]
        cfg = dataclasses.replace(cfg, pim_linear_mode="pim",
                                  pim_linear_bits=args.pim_bits,
                                  pim_block_mode=block_mode)
    # No --pim-backend: packed torch on CUDA (raises without a card).
    engine = Engine(args.pim_backend)
    model = build_model(cfg, engine=engine)
    log.info("model %s on %s (engine backend %s): %d layers, d_model %d, "
             "vocab %d, PIM scopes %s, mesh %s", cfg.name, model.device,
             engine.backend, cfg.n_layers, cfg.d_model, cfg.vocab_size,
             list(cfg.pim_scopes()),
             mesh.shape if mesh is not None else {"data": 1, "model": 1})
    params = model.init(0, mesh=mesh)

    # Full-block serving plan: lower every enabled scope's linears onto
    # co-scheduled crossbar groups before prefill and decode, so the
    # fused schedules compile (and verify) once here; every decode step
    # reuses them through the engine's cache (the gate below enforces it).
    plan = None
    device = None
    if pim:
        placer = None
        if args.device_config is not None:
            device = DeviceConfig.parse(args.device_config,
                                        crossbar=engine.crossbar)
            placer = CoordAllocator(device).place
            log.info("device hierarchy: %s (%d crossbars, %d banks)",
                     device, device.n_crossbars, device.n_banks)
        # With a real device budget, degrade gracefully on capacity
        # exhaustion: shed the groups that do not fit, and say which.
        plan = plan_block(cfg, engine, placer=placer,
                          on_capacity="shed" if device is not None
                          else "raise")
        if plan.shed:
            log.warning("device %s too small for scope plan: shed %d "
                        "group(s): %s (served scopes: %s)",
                        device, len(plan.shed), ", ".join(plan.shed),
                        list(plan.scopes))

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (args.batch, args.prompt_len))).to(model.device)
    frames = None
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        ).to(model.device)
    run = serve_model(model, params, prompts, engine, gen=args.gen,
                      cache_len=args.cache_len, frames=frames, mesh=mesh)
    log.info("prefill %d x %d: %.2fs", args.batch, args.prompt_len,
             run.prefill_s)
    log.info("generated %d x %d tokens in %.2fs (%.1f tok/s/seq)",
             args.batch, args.gen, run.decode_s, run.tokens_per_s)
    if args.gen > 1:
        log.info("decode latency/token: p50=%.1fus p90=%.1fus p99=%.1fus",
                 run.latency_us(50), run.latency_us(90), run.latency_us(99))
    post = run.stats_after
    obs.gauge("serve.tokens_per_sec").set(run.tokens_per_s)
    obs.gauge("serve.cache_hits").set(post["hits"])
    obs.gauge("serve.cache_misses").set(post["misses"])
    obs.gauge("serve.engine_runs").set(post["runs"])
    log.info("sample: %s", run.tokens[0][:16].tolist())
    log.info("placed bytes by rank: parameters %s, decode states %s",
             run.param_bytes, run.state_bytes)
    if pim:
        _log_pim(args, cfg, engine, plan, device, run)

    if not lead:
        return run
    if args.trace:
        if pim:
            _export_waterfalls(engine, plan, cfg.pim_linear_bits)
        n_ev = obs.export_trace(args.trace)
        log.info("trace: %d events -> %s", n_ev, args.trace)
    if args.metrics:
        obs.write_metrics(args.metrics)
        log.info("metrics snapshot -> %s", args.metrics)
    if args.summary:
        from repro_torch.kernels.crossbar_step import (crossbar_run,
                                                       crossbar_run_packed)
        out = run.summary()
        out["launches"] = {"K1": crossbar_run_packed.launches,
                           "K2": crossbar_run.launches}
        with open(args.summary, "w") as f:
            json.dump(out, f)
    return run


def main(argv: Optional[Sequence[str]] = None):
    """Parse the flags (``argv``, default ``sys.argv[1:]``) and serve:
    model mode, or traffic mode with ``--traffic``; exits nonzero when a
    gate fails. Returns model mode's :class:`GreedyRun` (the tokens and
    the engine's cache counters) or the continuous traffic run's
    :class:`~repro_torch.serve.LoadReport`."""
    ap = argparse.ArgumentParser(
        description="Serving launcher on the port's engine (on the card "
                    "unless --pim-backend says otherwise): model-mode "
                    "prefill and greedy decode, or continuous-batching "
                    "traffic with --traffic.")
    ap.add_argument("--arch", default="gemma2-9b",
                    help="architecture name (repro_torch.configs registry)")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config")
    ap.add_argument("--override", default="",
                    help="model mode: JSON dict of ModelConfig overrides "
                         "(e.g. '{\"n_layers\": 8}' for a cut in depth)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-parallel width: model mode's mesh is "
                         "(world / N, N) over the ranks of "
                         "torch.distributed.run")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="process-group backend under "
                         "torch.distributed.run: nccl (a card a rank; the "
                         "default on the card) or gloo (the CPU, or ranks "
                         "sharing one card; the default with a CPU "
                         "--pim-backend)")
    ap.add_argument("--pim", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="run the LM head as a PIM-mode linear through "
                         "the engine (default: on under --smoke)")
    ap.add_argument("--pim-scope", choices=["head", "ffn", "full"],
                    default="head",
                    help="how much of each block the PIM engine serves: "
                         "head = LM head only; ffn = + FFN projections "
                         "(incl. MoE experts); full = + attention "
                         "q/k/v/o — all via co-scheduled crossbar groups")
    ap.add_argument("--pim-bits", type=int, default=8)
    ap.add_argument("--pim-backend", default=None,
                    help="execution backend spec for the engine, e.g. "
                         "'torch:pack=true' (the default: K1 on CUDA), "
                         "'torch:pack=false' (K2) or "
                         "'torch:device=cpu,pack=true' (the kernels' "
                         "plain PyTorch versions on the host)")
    ap.add_argument("--device-config", default=None, metavar="CxGxBxX",
                    help="model a PIM device hierarchy "
                         "(repro_torch.device): channels x bank-groups x "
                         "banks x crossbars, e.g. '2x2x4x4'. Model mode "
                         "places the plan groups onto coordinates (shedding "
                         "what does not fit) and logs the charged cost; "
                         "traffic mode scales the slot budget with the "
                         "crossbar count")
    ap.add_argument("--traffic", type=int, default=None, metavar="N",
                    help="continuous-batching load mode: serve N "
                         "synthetic requests (seeded Poisson arrivals) "
                         "through the repro_torch.serve scheduler")
    ap.add_argument("--traffic-rate", type=float, default=200.0,
                    help="Poisson arrival rate, requests/second")
    ap.add_argument("--traffic-seed", type=int, default=0)
    ap.add_argument("--traffic-elems", type=int, default=None,
                    help="decode elements per token (MAC chain length; "
                         "default repro_torch.serve.DECODE_ELEMS)")
    ap.add_argument("--traffic-slots", type=int, default=None,
                    help="clamp the live-sequence slot budget (default: "
                         "the crossbar column-budget capacity)")
    ap.add_argument("--traffic-priority", choices=["prefill", "decode"],
                    default="prefill",
                    help="admission policy: prefill = backfill freed "
                         "slots mid-stream (best TTFT); decode = drain "
                         "the batch before admitting the next wave")
    ap.add_argument("--traffic-compare", action="store_true",
                    help="also replay the trace under per-pass "
                         "round-trip and serial one-request-at-a-time "
                         "scheduling and report both speedups")
    ap.add_argument("--traffic-check", type=float, default=None,
                    metavar="X",
                    help="hard gate (implies --traffic-compare): exit "
                         "nonzero unless speedup >= X, recompiles after "
                         "warmup == 0, and all schedules emit "
                         "bit-identical tokens")
    ap.add_argument("--traffic-resident-check", type=float, default=None,
                    metavar="X",
                    help="hard gate on the device-resident path (implies "
                         "--traffic-compare): exit nonzero unless "
                         "resident continuous batching is >= X faster "
                         "than the per-pass host round-trip on the same "
                         "trace (plus the zero-recompile and bit-parity "
                         "checks)")
    ap.add_argument("--fault-rate", type=float, default=None, metavar="P",
                    help="inject transient device faults: per-gate "
                         "bit-flip probability P, composed into the "
                         "backend spec as faults=flip@P@SEED (detection "
                         "and self-healing recovery run automatically "
                         "on the resident path)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault-model seed (reruns replay the identical "
                         "fault sequence)")
    ap.add_argument("--fault-check", action="store_true",
                    help="hard gate: exit nonzero unless the traffic run "
                         "stays bit-exact against the reference tokens "
                         "with zero recompiles after warmup and no "
                         "watchdog abort")
    ap.add_argument("--watchdog", type=float, default=None, metavar="S",
                    help="stall watchdog budget in seconds: abort the "
                         "traffic run cleanly (partial stats, report "
                         "aborted=True) if the scheduler makes no "
                         "progress for S seconds")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable span tracing and write a Chrome "
                         "trace-event file (chrome://tracing or "
                         "ui.perfetto.dev); in model mode the model's "
                         "steps and each PIM projection's phases (weight, "
                         "activation, product, dequant) and, with PIM, "
                         "the groups' "
                         "crossbar-waterfall counter tracks; no crossbar "
                         "pass is run for it")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="write the obs metrics snapshot (counters, "
                         "gauges, latency histograms) as JSON")
    ap.add_argument("--summary", default=None, metavar="OUT.json",
                    help="model mode: write the run's numbers (tokens, "
                         "prefill seconds, tokens/s, latency p50/p99, "
                         "mesh, each rank's placed and peak bytes and "
                         "recompiles, this process's kernel launches) as "
                         "JSON")
    args = ap.parse_args(argv)
    if args.traffic is not None and args.model_parallel != 1:
        raise SystemExit(f"--model-parallel {args.model_parallel}: traffic "
                         f"mode serves on one rank, as the reference's does")
    if "WORLD_SIZE" in os.environ and not dist.is_initialized() \
            and args.traffic is None:
        on_cpu = "device=cpu" in (args.pim_backend or "")
        dist.init_distributed(args.dist_backend
                              or ("gloo" if on_cpu else "nccl"))
    if args.model_parallel != 1 and not dist.is_initialized():
        raise SystemExit(f"--model-parallel {args.model_parallel}: one "
                         f"process is one rank; run one process a rank "
                         f"under python -m torch.distributed.run")
    lead = dist.rank() == 0
    obs.setup_logging(logging.INFO if lead else logging.WARNING)
    if args.trace and lead:
        obs.enable()
    if args.traffic is not None:
        return _run_traffic(args)
    return _run_model(args)


if __name__ == "__main__":
    main(sys.argv[1:])
