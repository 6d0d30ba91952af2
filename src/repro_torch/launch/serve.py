"""Serving launcher of the port: continuous-batching traffic on the H100.

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
``--fault-check`` gates the run bit-exact under them.

Without ``--pim-backend`` the launcher runs on the port's default engine,
packed torch on CUDA, and raises when there is no card. On the card::

  python -m repro_torch.launch.serve --traffic 32 --traffic-rate 500 \
      --fault-rate 1e-5 --fault-check

On the host, through the kernels' plain PyTorch versions::

  PYTHONPATH=src python -m repro_torch.launch.serve --traffic 16 \
      --pim-backend torch:device=cpu,pack=true --traffic-compare

The port's copy of ``repro.launch.serve``'s traffic mode
(``_run_traffic``, ``_log_report`` and the traffic flags of ``main``).
Model-mode serving (prefill and greedy decode over a model zoo
architecture, ``--arch``/``--pim-scope``) is not ported yet: without
``--traffic`` the launcher exits with a message saying so. The
reference's deprecated ``--pim-k`` (pin the batch width) is dropped:
``--traffic-slots`` clamps the slot budget, and K is load-driven.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch import obs
from repro_torch.device import DeviceConfig
from repro_torch.engine import Engine
from repro_torch.faults import get_fault_model
from repro_torch.pim import plan_serve_slots
from repro_torch.serve import (DECODE_ELEMS, TrafficConfig, compare_modes,
                               generate, run_load)

# No logging side effects at import time: handlers attach only when
# main() calls obs.setup_logging() (see repro_torch.obs.logging).
log = obs.get_logger("serve")

MODEL_MODE_MISSING = (
    "repro_torch.launch.serve runs traffic mode only: pass --traffic N. "
    "Model-mode serving (prefill and greedy decode over a model, "
    "--arch/--pim-scope) is not ported to repro_torch yet (ROADMAP "
    "item A10).")


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


def main(argv: Optional[Sequence[str]] = None):
    """Parse the traffic flags (``argv``, default ``sys.argv[1:]``) and
    run the traffic launcher; exits nonzero when a gate fails. Returns the
    continuous run's :class:`~repro_torch.serve.LoadReport`."""
    ap = argparse.ArgumentParser(
        description="Continuous-batching traffic launcher on the port's "
                    "engine (on the card unless --pim-backend says "
                    "otherwise).")
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
                         "banks x crossbars, e.g. '2x2x4x4'; the slot "
                         "budget scales with the crossbar count")
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
                         "ui.perfetto.dev)")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="write the obs metrics snapshot (counters, "
                         "gauges, latency histograms) as JSON")
    args = ap.parse_args(argv)
    if args.traffic is None:
        raise SystemExit(MODEL_MODE_MISSING)
    obs.setup_logging()
    if args.trace:
        obs.enable()
    return _run_traffic(args)


if __name__ == "__main__":
    main(sys.argv[1:])
