#!/usr/bin/env python3
"""The comparison's control, at a cell's own size, on the card.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \\
        [--controls tf32,bits7] [--program-bits 7] [--seconds S] \\
        [--out FILE]

For each seed, a run of the cell as ``bench/run.py`` makes it
(``run.run_cell``: set-up, ``--seconds`` of its closed loop, default
``run_seconds``, and the comparison with the cell's limits in
``bench/limits/<cell>.json``): the program's readings (the lower ones)
and its verdict. Then, on the jobs that run compared, each control put
in the program's place: the reference at a lower precision, its first
token at every position held against the float32 reference, judged by
the same limits. With ``--program-bits``, a second run a seed with the
program itself served at that PIM width (its own lower path, on the same
weights and prompts), judged by the reference at the configuration's
width and the same limits. Every control has to come out not correct.

Controls: ``tf32`` (the float products in TF32, the step below float32
with TF32 off), ``bf16`` (attention in bfloat16), ``bits7`` and
``bits4`` (the PIM projections at 7 and 4 bits instead of 8).

The benchmark's own runs do not run this; its readings set the limits.
One JSON line a seed on standard output (and into ``--out``).
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench_run  # noqa: E402

CONTROLS = {"tf32": dict(tf32=True), "bf16": dict(attn_dtype="bfloat16"),
            "bits7": dict(n_bits=7), "bits4": dict(n_bits=4)}


def control_reference(cfg, params, name):
    """The reference of ``cfg`` over ``params`` at control ``name``'s
    precision."""
    import torch
    from reference import Reference
    kw = dict(CONTROLS[name])
    if "attn_dtype" in kw:
        kw["attn_dtype"] = getattr(torch, kw["attn_dtype"])
    return Reference(cfg, params, **kw)


def _free(out) -> None:
    import torch
    out.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def control_verdict(spec, out, name, limits):
    """Control ``name`` put in the program's place on the jobs that the
    run ``out`` compared: its readings and its verdict by ``limits``."""
    from pimbench.check import combine, control_gaps, judge
    from reference import Reference, reference_config
    rcfg = reference_config(spec)
    ref = Reference(rcfg, out["params"])
    ctl = control_reference(rcfg, out["params"], name)
    device = out["params"]["embed"].device
    readings = combine([control_gaps(ref, ctl, j, device)
                        for j in out["checked"]])
    return {"correct": judge(readings, limits)[1], **readings}


def one_seed(cell, spec, traffic, limits, seed, seconds, controls,
             program_bits, **run_kw):
    """One seed's run of the cell and its controls' verdicts."""
    t0 = time.perf_counter()
    out = bench_run.run_cell(cell, spec, traffic, limits, seed=seed,
                             seconds=seconds, trace=False, **run_kw)
    rec = {"workload": cell["name"], "seed": seed,
           "program": {"correct": out["correct"], **out["readings"]},
           "jobs": [j.index for j in out["checked"]]}
    for name in controls:
        rec[name] = control_verdict(spec, out, name, limits)
    _free(out)
    for bits in program_bits:
        low = bench_run.run_cell(cell, spec, traffic, limits, seed=seed,
                                 seconds=seconds, trace=False,
                                 pim_bits=bits, **run_kw)
        rec[f"program_bits{bits}"] = {"correct": low["correct"],
                                      **low["readings"]}
        _free(low)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="tf32,bits7")
    ap.add_argument("--program-bits", default="",
                    help="PIM widths to serve the program itself at")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench_run.setup_paths()
    root = bench_run.ROOT
    bench = bench_run.load_json(root / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    spec = bench_run.load_json(root / conf["file"])
    traffic = bench_run.load_json(
        bench_run.BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = bench_run.load_json(
        bench_run.BENCH / "limits" / f"{cell['name']}.json")["limits"]
    seconds = args.seconds or float(bench["run_seconds"])
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = json.dumps(one_seed(
            cell, spec, traffic, limits, seed, seconds,
            [c for c in args.controls.split(",") if c],
            [int(b) for b in args.program_bits.split(",") if b]))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
