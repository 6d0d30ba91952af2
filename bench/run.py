#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``bench/configs/<config>.json``) under a traffic mix
(``bench/traffic/<traffic>.json``), with the limits of its comparison in
``bench/limits/<cell>.json``. A metric named ``<name>`` is read by
``bench/metrics/<name>.py`` or, failing that, by the file named after
the part of ``<name>`` before its first dot; each has ``read(run)``,
returning a number or None (nothing to read in this run). Adding a cell,
a traffic mix or a metric therefore adds files and entries and edits
none.

One run: set-up (the model built on the card, weights and prompts drawn
from ``--seed``, the shapes of the cell's traffic warmed), the measured
window of ``--seconds`` of the phase the cell is named for (tracing
off; ``pimbench.serving``: a decode cell's clock stops over a new job's
prefill), with ``--trace 1`` a profiled segment of the same phase after
it, then the comparison of what the timed path served with the plain
reference. The last line on standard output is
the result as one JSON object; the numbers compared and their limits
are the last lines on standard error. Without the cards the cell asks
for it prints no result and exits 3; if a module of JAX, flax or the JAX
package ``repro`` is loaded once the window has closed and the metrics
are read, it names it, prints no result and exits 4.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
LAYOUT_CACHE = BENCH / ".cache" / "layout"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup_paths() -> None:
    """The port's sources and the benchmark's own modules on the path,
    and every cache of the program at a fixed place in the checkout."""
    for p in (str(BENCH), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = BENCH / ".cache"
    os.environ["REPRO_CACHE_DIR"] = str(cache / "repro")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Run:
    """What one run measured, for the metric readers."""

    cell: Dict[str, Any]
    cfg: Any
    traffic: Dict[str, Any]
    setup_s: float
    window_s: float
    steps: List[Any]
    jobs: List[Any]
    peak_window_bytes: int
    kept_off: List[Any] = field(default_factory=list)
    trace: Any = None
    traced_steps: List[Any] = field(default_factory=list)
    calls: List[Any] = field(default_factory=list)
    marks: Dict[str, float] = field(default_factory=dict)

    def window_jobs(self) -> List[Any]:
        """Jobs whose prefill ran in the window and that completed in it."""
        first = {s.job for s in self.steps if s.kind == "prefill"}
        end = self.steps[-1].t1 if self.steps else 0.0
        return [j for j in self.jobs if j.index in first
                and j.done is not None and j.done <= end]


def reader(name: str):
    """``read`` of the metric ``name`` (see the module docstring)."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{BENCH / 'metrics'}")


def reported(metric: Dict[str, Any], cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (every cell, without a
    ``workloads`` key)."""
    return cell in metric.get("workloads", [cell])


def _ints(counts) -> Optional[List[int]]:
    """A ragged call's segment lengths as ints (None for a dense call)."""
    if counts is None:
        return None
    return [int(c) for c in (counts.tolist() if hasattr(counts, "tolist")
                             else counts)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Dict[str, Any], spec: Dict[str, Any],
             traffic: Dict[str, Any], limits: Dict[str, float], *,
             seed: int, seconds: float, trace: bool, device: str = "cuda",
             backend: Optional[str] = None,
             pim_bits: Optional[int] = None) -> Dict[str, Any]:
    """One run of ``cell``: ``{"run"}`` the measured :class:`Run`,
    ``{"check", "correct"}`` the comparison's numbers beside their limits
    and its verdict, ``{"readings"}`` all it read, ``{"checked"}`` the
    jobs it compared, ``{"peak"}`` the card's peak bytes before it,
    ``{"attempted"}`` the sequences served, ``{"params"}`` the weights
    drawn. ``pim_bits`` serves the program at another PIM width than the
    configuration states (its own lower path, the comparison's control);
    the reference keeps the configuration's."""
    import dataclasses
    import statistics

    import torch
    from pimbench.check import combine, gaps, judge, pick_jobs
    from pimbench.config import model_config
    from pimbench.engine import traced_engine
    from pimbench.serving import Server
    from pimbench.trace import profile
    from pimbench.weights import PromptStream, draw_weights, param_layout
    from reference import Reference, reference_config
    from repro_torch.engine import Engine
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"
    marks = {"imports": time.perf_counter() - T_START}
    if cuda:
        torch.empty(1, device=device)
        torch.cuda.synchronize()
        marks["cuda_context"] = time.perf_counter() - T_START
    cfg = model_config(spec, cell["config"])
    if pim_bits is not None:
        cfg = dataclasses.replace(cfg, pim_linear_bits=int(pim_bits))
    engine = traced_engine(backend) if trace else Engine(backend)
    model = build_model(cfg, engine=engine)
    marks["model"] = time.perf_counter() - T_START
    layout = param_layout(cfg, cache_dir=LAYOUT_CACHE)
    marks["layout"] = time.perf_counter() - T_START
    params = draw_weights(cfg, seed, model.device, layout=layout)
    if cuda:
        torch.cuda.synchronize()
    marks["weights"] = time.perf_counter() - T_START
    prompts = PromptStream(seed, int(traffic["batch"]),
                           int(traffic["prompt_len"]), cfg.vocab_size,
                           model.device)
    server = Server(model, params, traffic, prompts)
    unit = traffic["window_unit"]

    first_job = server.warm_up(unit)
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START

    window = server.run(seconds, unit)
    peak = max(peak, window.kept_off_peak_bytes)
    run = Run(cell, cfg, traffic, setup_s, window.seconds, window.steps,
              server.jobs, window.peak_bytes, kept_off=window.kept_off,
              marks=marks)
    if trace:
        trace_s = float(traffic["trace_seconds"])
        if unit == "step":
            # Room for the segment's decode steps (a traced step is
            # slower) in the job, so that no prefill falls inside it.
            step_s = statistics.median(st.seconds for st in window.steps)
            server.make_room(int(3 * trace_s / step_s) + 1)
        engine.calls = []
        run.traced_steps, run.trace = profile(
            lambda: server.run(trace_s, unit, new_jobs=False).steps)
        run.calls = [c[:5] + (_ints(c[5]),) for c in engine.calls]
        engine.calls = None
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated())

    # The comparison, once the program's state is freed.
    server.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = Reference(reference_config(spec), params)
    jobs = pick_jobs(server.jobs, first_job, int(traffic["check_jobs"]),
                     seed)
    readings = (combine([gaps(ref, job, model.device) for job in jobs])
                if jobs else {})
    check, correct = judge(readings, limits)
    readings["check_s"] = time.perf_counter() - t_check
    return {"run": run, "check": check, "correct": correct, "peak": peak,
            "readings": readings, "checked": jobs,
            "params": params,
            "attempted": sum(j.prompts.shape[0] for j in server.jobs
                             if j.index >= first_job)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_paths()
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    spec = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{cell['name']}.json")["limits"]
    metrics = bench["per_layer"] if args.trace else bench["end_to_end"]
    metrics = [m for m in metrics if reported(m, cell["name"])]

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(cell, spec, traffic, limits, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace))
    return report(cell, metrics, out, bool(args.trace))


def report(cell: Dict[str, Any], metrics: List[Dict[str, Any]],
           out: Dict[str, Any], trace: bool) -> int:
    """Read ``metrics`` from the run ``out`` (:func:`run_cell`'s), print
    the numbers compared beside their limits on standard error and the
    result's line on standard output, and return 0; or, if a module of
    JAX, flax or the JAX package is loaded by then (by the port or by a
    metric's reader), name it on standard error, print no result and
    return 4."""
    import torch
    from pimbench.host import summary
    from pimbench.work import power_limit

    run = out["run"]
    values = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        return 4
    card = power_limit()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": out["peak"],
              "power": card}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": 0, "metrics": values, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": [list(x) for x in run.trace.device_ops],
            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    result["check"] = out["check"]
    print(f"card: {card}; window {run.window_s:.6f} s; "
          f"set-up {run.setup_s:.6f} s", file=sys.stderr)
    ms = sorted(st.seconds * 1e3 for st in run.steps)
    print(f"set-up marks (s from start): {json.dumps(run.marks)}; "
          f"{len(ms)} window steps, ms min {ms[0]:.1f} median "
          f"{ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}; "
          f"{len(run.kept_off)} prefills kept off the window "
          f"({sum(st.seconds for st in run.kept_off):.3f} s); "
          f"window peak {run.peak_window_bytes} B", file=sys.stderr)
    print("host " + json.dumps({"decode": summary(run.steps)}),
          file=sys.stderr)
    print("readings " + json.dumps(out["readings"]), file=sys.stderr)
    for key, c in out["check"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
