"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, imports nothing of JAX and nothing of the ``repro`` package,
and raises on any failure. Phases, one line each:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/csrc`` into
   ``build/repro_torch/``;
3. K1 (packed kernel) against its plain PyTorch version at macro 1 and
   8, bit-exact, at 32,768 words (2^20 crossbar rows) for the
   ``multpim``, ``multpim_mac``, ``stage`` and ``recomb`` N = 32 tables,
   with CUDA-event timings;
4. K2 (unpacked kernel) against its plain version on ``multpim`` N = 32
   over 2^20 rows;
5. the front door: ``Engine("torch:pack=true").compile("multpim", 32)
   .run`` over 2^20 random 32-bit pairs against numpy's exact products,
   then the same with ``pack=false``;
6. the resident matrix-vector product ``Engine.matvec`` of a
   (2^20 x 8) matrix at N = 32 against numpy's exact ``A @ x``;
7. one JSON line describing each kernel;
8. ``{"ok": true, "device": {...}}`` as the last line.

The launch counts of the kernels' wrappers are set to 0 just before each
path of phases 5 and 6 and read just after; comparison launches of
phases 3 and 4 do not count.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_BITS = 32
ROWS = 1 << 20
WORDS = ROWS // 32
MATVEC_ELEMS = 8
# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bandwidth, and the float32 rate outside the tensor cores, used here for
# the kernels' 32-bit bitwise lane operations.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
K1_REPLACES = "src/repro/kernels/crossbar_step.py:130"
K2_REPLACES = "src/repro/kernels/crossbar_step.py:62"
SOURCE = "src/repro_torch/csrc/crossbar_step.cu"
NO_LIBRARY = "no single PyTorch call computes a crossbar program"


def check(cond: bool, msg: str) -> None:
    """Raise when a phase's check fails."""
    if not cond:
        raise RuntimeError(msg)


def phase(name: str, **fields) -> None:
    """One line per phase on standard output."""
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, warmup: int, reps: int) -> float:
    """Median of per-call CUDA-event timings after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference between two integer tensors."""
    return float((got.long() - want.long()).abs().max().item())


def gate_ops(gate_id: np.ndarray) -> int:
    """Instructions the gates of one table need per word (or row): one
    sm_90 LOP3 computes any 3-input boolean function, so a gate with its
    AND-write into the output cell is one instruction, MIN3 (four
    inputs with the output cell) two; NOP slots do nothing."""
    from repro_torch.core.isa import Gate
    cost = {Gate.NOT: 1, Gate.NOR: 1, Gate.MIN3: 2, Gate.NAND: 1,
            Gate.OR: 1, Gate.COPY: 1}
    return sum(int((gate_id == int(g)).sum()) * c for g, c in cost.items())


def bound_ms(packed, items: int, cell_bytes: int) -> "tuple[float, str]":
    """Least time for one pass over ``items`` words (or rows): the
    larger of the state in and out over HBM (tables read once) and the
    gate instructions (with their AND-writes) over the peak 32-bit
    rate. A SET cell costs no instruction: it writes a constant, which
    the next instruction on that cell takes as an operand."""
    t, m = packed.gate_id.shape
    c = packed.init_mask.shape[1]
    table_bytes = 5 * t * m * 4 + (t + 1) * 4 + int(packed.init_mask.sum()) * 4
    n_bytes = 2 * items * c * cell_bytes + table_bytes
    ops = items * gate_ops(packed.gate_id)
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def main() -> None:
    """Run every phase on card 0; raise on the first failure."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import obs
    from repro_torch.compiler.cache import compile_cached
    from repro_torch.engine import Engine
    from repro_torch.kernels import _build
    from repro_torch.kernels.crossbar_step import (crossbar_run,
                                                   crossbar_run_packed)
    from repro_torch.kernels.ref import (crossbar_run_ref,
                                         crossbar_run_ref_packed)

    t_start = time.perf_counter()
    # ---------------------------------------------------------- 1. card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # --------------------------------------------------------- 2. build ----
    lib, build_s = _build.build()
    _build.load_library()
    phase("build", library=lib.name, nvcc_seconds=round(build_s, 3))

    rng = np.random.default_rng(0)
    programs = {k: compile_cached(k, N_BITS).packed
                for k in ("multpim", "multpim_mac", "stage", "recomb")}

    # ------------------------------------------------- 3. K1 vs its twin ----
    k1_rows = []
    k1_err = 0.0
    for name, packed in programs.items():
        c = packed.init_mask.shape[1]
        st = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (WORDS, c), dtype=np.int64
        ).astype(np.int32)).to(dev)
        got = crossbar_run_packed(st, packed)
        for macro in (1, 8):
            want = crossbar_run_ref_packed(st, packed, macro=macro)
            torch.cuda.synchronize()
            k1_err = max(k1_err, max_abs_err(got, want))
            check(torch.equal(got, want),
                  f"K1 disagrees with its plain version on {name} "
                  f"macro={macro}")
        ms = time_ms(lambda: crossbar_run_packed(st, packed), 3, 20)
        plain = time_ms(lambda: crossbar_run_ref_packed(st, packed, macro=8),
                        1, 3)
        bms, by = bound_ms(packed, WORDS, 4)
        k1_rows.append({"shape": [WORDS, c], "ms": ms, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by})
        phase("K1", program=name, words=WORDS, cols=c, exact=True,
              macro="1,8", ms=ms, plain_ms=plain, bound_ms=bms,
              bound_by=by)
        del st, got, want

    # ------------------------------------------------- 4. K2 vs its twin ----
    mp = programs["multpim"]
    c = mp.init_mask.shape[1]
    sb = torch.from_numpy(rng.integers(0, 2, (ROWS, c),
                                       dtype=np.uint8)).to(dev)
    got = crossbar_run(sb, mp)
    want = crossbar_run_ref(sb, mp)
    torch.cuda.synchronize()
    k2_err = max_abs_err(got, want)
    check(torch.equal(got, want), "K2 disagrees with its plain version")
    k2_ms = time_ms(lambda: crossbar_run(sb, mp), 2, 10)
    k2_plain = time_ms(lambda: crossbar_run_ref(sb, mp), 1, 3)
    k2_bound, k2_by = bound_ms(mp, ROWS, 1)
    phase("K2", program="multpim", rows=ROWS, cols=c, exact=True,
          ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by)
    del sb, got, want
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 5. front door ----
    main_launches = {"K1": 0, "K2": 0}
    a = rng.integers(0, 1 << N_BITS, ROWS, dtype=np.uint64)
    b = rng.integers(0, 1 << N_BITS, ROWS, dtype=np.uint64)
    exact = a * b                       # < 2^64: exact in uint64
    for pack, kern in ((True, "K1"), (False, "K2")):
        eng = Engine(f"torch:pack={str(pack).lower()}")
        exe = eng.compile("multpim", N_BITS)
        crossbar_run_packed.launches = 0
        crossbar_run.launches = 0
        t0 = time.perf_counter()
        out = exe.run({"a": a, "b": b})["out"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"K1": crossbar_run_packed.launches,
                  "K2": crossbar_run.launches}
        check(counts[kern] == 1 and sum(counts.values()) == 1,
              f"front door pack={pack} launched {counts}")
        main_launches[kern] += counts[kern]
        check(np.array_equal(out.astype(np.uint64), exact),
              f"front door pack={pack} products disagree with numpy")
        phase("front_door", op="multpim", n=N_BITS, rows=ROWS, pack=pack,
              exact=True, launches=counts, wall_s=round(wall, 3))
    # the same engine on a small input against the host interpreter
    small = {"a": a[:70], "b": b[:70]}
    on_card = Engine("torch:pack=true").compile("multpim", N_BITS).run(small)
    on_host = Engine("numpy").compile("multpim", N_BITS).run(small)
    check(all(int(x) == int(y) for x, y in zip(on_card["out"],
                                                on_host["out"])),
          "card and host interpreter disagree on a small input")

    # -------------------------------------------- 6. resident matvec ----
    A = rng.integers(0, 1 << 30, (ROWS, MATVEC_ELEMS), dtype=np.int64)
    x = rng.integers(0, 1 << 30, MATVEC_ELEMS, dtype=np.int64)
    want_mv = A.astype(np.uint64) @ x.astype(np.uint64)
    eng = Engine("torch:pack=true")
    eng.resident(N_BITS, rows=ROWS)          # compile outside the window
    tracer = obs.get_tracer()
    tracer.reset()
    tracer.enable()
    crossbar_run_packed.launches = 0
    crossbar_run.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, cycles = eng.matvec(A, x, N_BITS, k=1, resident=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracer.disable()
    spans = [e["name"] for e in tracer.trace_dict()["traceEvents"]
             if e.get("ph") == "X"]
    tracer.reset()
    k1_mv, k2_mv = crossbar_run_packed.launches, crossbar_run.launches
    want_launches = 1 + 2 * (MATVEC_ELEMS - 1) + 1
    check(k1_mv == want_launches and k2_mv == 0,
          f"resident matvec launched K1 {k1_mv} times (want "
          f"{want_launches}) and K2 {k2_mv} times")
    check(spans.count("backend.unpack") == 1,
          f"resident matvec read the device {spans.count('backend.unpack')}"
          f" times (want 1)")
    check(np.array_equal(np.array(res, dtype=np.uint64), want_mv),
          "resident matvec disagrees with numpy A @ x")
    main_launches["K1"] += k1_mv
    passes = 2 * MATVEC_ELEMS
    phase("resident_matvec", shape=f"{ROWS}x{MATVEC_ELEMS}", n=N_BITS,
          exact=True, k1_launches=k1_mv, device_reads=1,
          modeled_cycles=cycles, wall_s=round(wall, 3),
          passes_per_s=round(passes / wall, 3))
    check(main_launches["K1"] > 0 and main_launches["K2"] > 0,
          f"a kernel of the main path never launched: {main_launches}")

    # -------------------------------------------------- 7. kernels line ----
    phase("done", seconds=round(time.perf_counter() - t_start, 1))
    k1_main = k1_rows[0]            # multpim N=32, the front door's pass
    kernels = [
        {"name": "K1 crossbar_run_packed (bit-plane packed)",
         "route": "cuda", "source": SOURCE, "replaces": K1_REPLACES,
         "launches": main_launches["K1"], "max_abs_err": k1_err,
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": None, "library_note": NO_LIBRARY,
         "shape": f"multpim N={N_BITS}, {WORDS} words x "
                  f"{k1_main['shape'][1]} columns"},
        {"name": "K2 crossbar_run (unpacked)",
         "route": "cuda", "source": SOURCE, "replaces": K2_REPLACES,
         "launches": main_launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None, "library_note": NO_LIBRARY,
         "shape": f"multpim N={N_BITS}, {ROWS} rows x {c} columns"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
