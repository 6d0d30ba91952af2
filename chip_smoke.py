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
   with CUDA-event timings, the bytes bound and the shared-memory floor;
   then on the fused table of two co-scheduled N = 32 MACs at 2^15
   words, and on two tables whose cycles write one column twice; then
   on the serve path's n = 8 tables: the resident chain's
   ``multpim_mac``, ``stage`` and ``recomb`` and the detect-mode
   ``residue`` check at 256 words (``serve_device``'s 8,192 lanes) and
   at 1 word (8 lanes), and the fused round-trip and serial passes
   ``compile_batch("mac", 8, k)``, k = 1, 2, 4, 8, at 1 word;
4. K2 (unpacked kernel) against its plain version on ``multpim`` N = 32
   over 2^20 rows, with CUDA-event timings, then on the co-scheduled
   table at 2^15 rows, a held table at a ragged row count, the two
   duplicate-write tables, and the fused n = 8 serve tables at 1 and 8
   rows (the round-trip passes of ``serve_unpacked``);
5. the front door: ``Engine("torch:pack=true").compile("multpim", 32)
   .run`` over 2^20 random 32-bit pairs against numpy's exact products,
   then the same with ``pack=false``; each with its untraced wall, then
   a second run with ``repro_torch.obs`` tracing on: its wall and span
   seconds, and with ``pack=false`` the ``backend.kernel`` span (both
   copies and K2) and the rest of that wall;
6. the resident matrix-vector product ``Engine.matvec`` of a
   (2^20 x 8) matrix at N = 32 against numpy's exact ``A @ x``; then
   the co-scheduled default (``matvec`` with no ``k``: the engine's
   policy, k = min(coschedule_k, E) MACs fused into one K1 pass) of a
   (2^15 x 8) matrix at N = 8, 16 and 32, products against numpy and
   cycles against the host interpreter's, and one ``compile_group``
   pass (two MACs, a multiplier, a RIME multiplier) against the host
   interpreter;
7. K3 (bit-serial matmul) against its plain version at M = 256 tokens:
   bit-exact at (M, K, N) = (256, 256, 4096) with integer w in [0, 255],
   and within tolerance with float w at one deepseek-7b layer's
   projection shapes (attn.q 4096 x 4096, ffn gate+up 4096 x 22016,
   ffn down 11008 x 4096), with CUDA-event timings of K3, its plain
   version and ``torch.matmul``;
8. ``Engine.linear(mode="pim")`` on the card at those shapes, with and
   without K3, against a host float64 oracle, and the K3 path also
   against K3's plain version on the layer's own quantized operands;
9. ``Engine.ragged_linear(mode="pim")`` at deepseek-moe-16b's expert
   widths (D 2048, F 1408, 64 experts, 256 tokens x top-6) against a
   host float64 per-segment oracle;
10. ``serve_compare``: the serve load trace of the reference's CI (32
    requests, Poisson 500 req/s, seed 0, n = 8, 4 decode elements a
    token) replayed in real time by ``compare_modes`` on
    ``torch:pack=true`` (resident continuous, per-pass round-trip,
    serial): tokens equal the plain-int reference in every mode, zero
    recompiles, K1 launches in every mode; per mode tokens/s, wall,
    passes, steps, TTFT and per-token p50/p99, and both speedups
    (printed, not gated);
11. ``serve_unpacked``: the same trace, continuous, on
    ``torch:pack=false`` (no resident chain without packing: round-trip
    passes through K2), bit-exact;
12. ``serve_device``: the slice at full size — a ``2x4x16x8`` device
    (1,024 crossbars, 8 lanes each at n = 8: 8,192 resident lanes),
    8,192 requests at 8,192 req/s, continuous, bit-exact with zero
    recompiles; an untraced run for tokens/s, TTFT and token p99, then a
    traced run for the span seconds, and K1's CUDA-event time per pass
    at these 256 words times the passes (the device time; K1's launch
    returns before the card finishes, so its span holds the enqueue);
13. ``serve_faults``: the reference CI's two gated fault runs through
    the launcher (``--fault-check --watchdog 120``, without faults and
    with ``--fault-rate 1e-5 --fault-seed 0``), then the faulty one at
    ``serve_device``'s full size (8,192 requests on ``2x4x16x8``), each
    bit-exact with zero recompiles and no abort, with the ``faults.*``
    and ``serve.fault.*`` counters, and the faulty pass's CUDA-event time against K1's at 1
    word (8 lanes) and 256 words (8,192 lanes); then a
    fault-free resident chain with detection forced on (K1 runs the
    residue program at each drain) at 8,192 lanes, exact;
14. one JSON line describing each kernel;
15. ``{"ok": true, "device": {...}}`` as the last line.

The launch counts of the kernels' wrappers are set to 0 just before each
path of phases 5, 6, 8 and 10-13 and read just after (one K3 launch per
``use_pallas=True`` call, one K1 launch per fused pass or resident
program pass); comparison launches of phases 3, 4, 7 and 12's timing do
not count. Float32 products run without TF32
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False): K3's plain version
and the library yardstick are full float32.
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
COSCHED_ROWS = 1 << 15
COSCHED_BITS = (8, 16, 32)
# A heterogeneous co-scheduled group: two MACs, a multiplier and a RIME
# multiplier in one crossbar pass.
GROUP = [("mac", 8, 2), ("multpim", 4), ("rime", 4)]
# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bandwidth, the float32 rate outside the tensor cores (used here for the
# kernels' 32-bit bitwise lane operations and for K3's former CUDA-core
# design), and the dense bf16 tensor-core rate (K3's split products).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
SMS = 132
# K1's shared-memory floor: per real op, 3 operand gathers, the output
# cell's load and its store, each one warp-wide access (one wavefront) per
# 32 words; an SM serves one wavefront a clock.
K1_SMEM_ACCESSES_PER_OP = 5
K1_REPLACES = "src/repro/kernels/crossbar_step.py:130"
K2_REPLACES = "src/repro/kernels/crossbar_step.py:62"
K3_REPLACES = "src/repro/kernels/bitserial_matmul.py:39"
SOURCE = "src/repro_torch/csrc/crossbar_step.cu"
K3_SOURCE = "src/repro_torch/csrc/bitserial_matmul.cu"
NO_LIBRARY = "no single PyTorch call computes a crossbar program"
# The PIM-linear slice: M tokens through one deepseek-7b layer's
# projections (d_model 4096, d_ff 11008; gate and up fused), and the
# deepseek-moe-16b expert GEMM (d_model 2048, expert d_ff 1408, 64
# experts, top-6).
LINEAR_BITS = 8
TOKENS = 256
LINEAR_SHAPES = {"attn.q": (4096, 4096), "ffn.gate_up": (4096, 22016),
                 "ffn.down": (11008, 4096)}
EXACT_SHAPE = (256, 4096)            # (K, N): 256 * 255 * 255 < 2^24
MOE = {"d": 2048, "f": 1408, "experts": 64, "top_k": 6}
# The serve slice: the reference CI's load trace (32 requests at 500
# req/s, seed 0, n = 8) and a 2x4x16x8 device of 1,024 crossbars (8
# lanes each at n = 8) under 8,192 requests arriving over about 1 s.
SERVE_BITS = 8
SERVE_REQUESTS = 32
SERVE_RATE = 500.0
DEVICE_CONFIG = "2x4x16x8"
DEVICE_REQUESTS = 8192
DEVICE_WORDS = DEVICE_REQUESTS // 32
DEVICE_RATE = 8192.0
FAULT_RATE = 1e-5
WATCHDOG_S = 120.0
# K3's tolerance against its plain version with float w: the
# reference's rtol 1e-4 / atol 5e-3, with rtol taken against the scale
# of the summed terms, |x| @ |w|. At K = 4096 and 11008 cancellation
# leaves some outputs near 0, where the float32 order alone moves a
# result by more than 1e-4 of itself; the bound of a float32 sum scales
# with its terms, not with its result.
K3_RTOL = 1e-4
K3_ATOL = 5e-3


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


def k3_bound_ms(m: int, k: int, n: int,
                n_bits: int = LINEAR_BITS) -> "tuple[float, str]":
    """Least time for K3 at (m, k, n): the split's bf16 products,
    ceil(n_bits / 8) x 3 x 2 m k n flops, at the dense bf16 tensor-core
    rate, or x, w and out moved once over HBM (int32 and float32, 4 bytes
    each), whichever is larger. The TPU's plane form would do n_bits
    times 2 m k n."""
    by_ops = -(-n_bits // 8) * 3 * 2 * m * k * n / BF16_FLOPS_PER_S * 1e3
    by_bytes = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def k3_cuda_core_bound_ms(m: int, k: int, n: int) -> float:
    """The bound of K3's former CUDA-core design: 2 m k n float32 flops
    at 67 TFLOP/s (kept beside the new bound for comparison)."""
    return 2 * m * k * n / OPS_PER_S * 1e3


def k3_int_tol(k: int, n_bits: int) -> float:
    """Largest error, in integer units, of the float32 K3 path of
    Engine.linear against exact integers: each addition in the product
    and the zero-point correction rounds by at most half an ulp of the
    largest value it can reach (2 K (2^n - 1)^2 bounds every partial sum
    of the product and of the correction), and there are fewer than
    K + n_bits + 3 of them on any order of the sums."""
    ulp = float(np.spacing(np.float32(2 * k * (2 ** n_bits - 1) ** 2)))
    return (k + n_bits + 3) * ulp


def host_oracle(xq, wq) -> np.ndarray:
    """float64 ``(xq - zx) @ (wq - zw) * sx * sw`` on the host, from the
    card's own quantized operands (float64 BLAS: exact integer sums)."""
    xi = xq.q.cpu().numpy().astype(np.float64) - xq.zero
    wi = wq.q.cpu().numpy().astype(np.float64) - wq.zero
    return ((xi @ wi) * xq.scale.cpu().numpy().astype(np.float64)
            * wq.scale.cpu().numpy().astype(np.float64))


def k3_phase(dev, tokens: int, exact_shape, shapes, seed: int) -> dict:
    """Phase 7: K3 against its plain version (and float64) at the exact
    shape with integer w, and at ``shapes`` with float w; timings of
    K3, the plain version and ``torch.matmul`` at each."""
    from repro_torch.kernels.bitserial_matmul import bitserial_matmul
    from repro_torch.kernels.ref import bitserial_matmul_ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, n = exact_shape
    x = torch.randint(0, 2 ** LINEAR_BITS, (tokens, k), generator=gen,
                      device=dev, dtype=torch.int32)
    w = torch.randint(0, 2 ** LINEAR_BITS, (k, n), generator=gen,
                      device=dev, dtype=torch.int32).float()
    got = bitserial_matmul(x, w, LINEAR_BITS)
    want = bitserial_matmul_ref(x, w, LINEAR_BITS)
    exact = (x.double() @ w.double()).float()
    check(torch.equal(got, want) and torch.equal(got, exact),
          "K3 is not bit-exact with integer w in the exact range")
    phase("K3", shape=f"{tokens}x{k}x{n}", w="int[0,255]", exact=True)
    rows = []
    err = 0.0
    for name, (k, n) in shapes.items():
        x = torch.randint(0, 2 ** LINEAR_BITS, (tokens, k), generator=gen,
                          device=dev, dtype=torch.int32)
        w = torch.randn((k, n), generator=gen, device=dev)
        got = bitserial_matmul(x, w, LINEAR_BITS)
        want = bitserial_matmul_ref(x, w, LINEAR_BITS)
        exact = x.double() @ w.double()
        terms = x.double().abs() @ w.double().abs()
        diff = (got.double() - want.double()).abs()
        worst = float((diff / (K3_ATOL + K3_RTOL * terms)).max())
        check(worst <= 1.0, f"K3 disagrees with its plain version at "
                            f"{name}: {worst} of the tolerance")
        elementwise = int((diff > K3_ATOL + K3_RTOL
                           * want.double().abs()).sum())
        err = max(err, float(diff.max()))
        ms = time_ms(lambda: bitserial_matmul(x, w, LINEAR_BITS), 3, 20)
        plain = time_ms(lambda: bitserial_matmul_ref(x, w, LINEAR_BITS),
                        2, 10)
        lib = time_ms(lambda: torch.matmul(x.float(), w), 3, 20)
        bms, by = k3_bound_ms(tokens, k, n)
        row = {"name": name, "shape": [tokens, k, n], "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
               "bound_by": by, "max_abs_err": float(diff.max()),
               "k3_err_vs_f64": float((got.double() - exact).abs().max()),
               "plain_err_vs_f64": float((want.double() - exact)
                                         .abs().max()),
               "outside_elementwise_tol": elementwise,
               "worst_share_of_tol": worst}
        rows.append(row)
        # The former CUDA-core design's bound, in the phase line only.
        phase("K3", **{key: row[key] for key in row if key != "name"},
              cuda_core_bound_ms=k3_cuda_core_bound_ms(tokens, k, n),
              layer=name)
        del x, w, got, want, exact, terms, diff
    return {"rows": rows, "max_abs_err": err}


def coschedule_phase(rng) -> int:
    """Phase 6, co-scheduled: ``matvec`` with the default k on the card
    (one K1 launch per fused pass of k MACs) against numpy's products
    and the host interpreter's cycle count, and one ``compile_group``
    pass against the host interpreter. Returns the K1 launches."""
    from repro_torch.engine import Engine
    from repro_torch.kernels.crossbar_step import crossbar_run_packed
    card, host = Engine("torch:pack=true"), Engine("numpy")
    total = 0
    for n in COSCHED_BITS:
        k = card.effective_coschedule_k("mac", n)
        check(k >= 2, f"co-scheduling is off at N={n} (k={k})")
        A = rng.integers(0, 1 << (n - 2), (COSCHED_ROWS, MATVEC_ELEMS))
        x = rng.integers(0, 1 << (n - 2), MATVEC_ELEMS)
        card.compile_batch("mac", n, k)      # compile outside the window
        crossbar_run_packed.launches = 0
        t0 = time.perf_counter()
        res, cycles = card.matvec(A, x, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = crossbar_run_packed.launches
        passes = -(-MATVEC_ELEMS // k)
        check(launches == passes, f"default-k matvec at N={n} launched "
                                  f"K1 {launches} times (want {passes})")
        want = (A.astype(object) @ x.astype(object)) & ((1 << 2 * n) - 1)
        check(all(int(r) == int(w) for r, w in zip(res, want)),
              f"default-k matvec at N={n} disagrees with numpy")
        _, host_cycles = host.matvec(A[:64], x, n)
        _, chain_cycles = host.matvec(A[:64], x, n, k=1)
        check(cycles == host_cycles < chain_cycles,
              f"default-k matvec at N={n}: {cycles} cycles, host "
              f"{host_cycles}, k=1 chain {chain_cycles}")
        total += launches
        phase("coscheduled_matvec", n=n, shape=f"{COSCHED_ROWS}x"
              f"{MATVEC_ELEMS}", k=k, exact=True, k1_launches=launches,
              modeled_cycles=cycles, chain_cycles=chain_cycles,
              wall_s=round(wall, 3))
    rows = COSCHED_ROWS
    inputs = [{name: rng.integers(0, 2, (rows, 8), dtype=np.uint8)
               for name in ("a", "b", "un", "s_lo", "c_lo", "c_lo_n")}
              for _ in range(2)]
    inputs += [{"a": rng.integers(0, 16, rows),
                "b": rng.integers(0, 16, rows)} for _ in range(2)]
    gex = card.compile_group(GROUP)
    crossbar_run_packed.launches = 0
    got = gex.run(inputs)
    launches = crossbar_run_packed.launches
    check(launches == 1, f"compile_group pass launched K1 {launches} times")
    want = host.compile_group(GROUP).run(inputs)
    for slot, (g, w) in enumerate(zip(got, want)):
        check(set(g) == set(w) and all(
            np.array_equal(np.asarray(g[o], dtype=object),
                           np.asarray(w[o], dtype=object)) for o in w),
            f"compile_group slot {slot} disagrees with the host interpreter")
    check(all(int(v) == int(p) * int(q) for v, p, q in zip(
        got[2]["out"], inputs[2]["a"], inputs[2]["b"])),
        "compile_group multiplier slot disagrees with numpy")
    total += launches
    phase("compile_group", group=GROUP, rows=rows, k=gex.k, exact=True,
          k1_launches=launches)
    return total


def linear_phase(eng, dev, tokens: int, shapes, seed: int) -> dict:
    """Phase 8: Engine.linear(mode="pim") on the card, exact path and K3
    path, against the host float64 oracle; K3 launches counted from 0
    over the phase."""
    from repro_torch.kernels.bitserial_matmul import bitserial_matmul
    from repro_torch.kernels.ref import bitserial_matmul_ref
    from repro_torch.pim.quant import quantize
    gen = torch.Generator(device=dev).manual_seed(seed)
    bitserial_matmul.launches = 0
    calls = 0
    for name, (k, n) in shapes.items():
        x = torch.randn((tokens, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        y = eng.linear(x, w, n_bits=LINEAR_BITS, mode="pim")
        sync(dev)
        t_exact = time.perf_counter() - t0
        t0 = time.perf_counter()
        y3 = eng.linear(x, w, n_bits=LINEAR_BITS, mode="pim",
                        use_pallas=True)
        sync(dev)
        t_k3 = time.perf_counter() - t0
        calls += 1
        check(y.device == x.device and y3.device == x.device,
              "Engine.linear left the card")
        xq = quantize(x, LINEAR_BITS)
        wq = quantize(w, LINEAR_BITS, axis=0)
        oracle = host_oracle(xq, wq)
        y = y.cpu().numpy().astype(np.float64)
        y3 = y3.cpu().numpy().astype(np.float64)
        check(y.shape == y3.shape == (tokens, n)
              and np.isfinite(y).all() and np.isfinite(y3).all(),
              f"Engine.linear at {name}: wrong shape or non-finite values")
        rel = np.abs(y - oracle) / np.maximum(np.abs(oracle), 1e-300)
        exact_ok = np.all(np.abs(y - oracle) <= 1e-6 * np.abs(oracle))
        check(exact_ok, f"Engine.linear pim at {name} is off the float64 "
                        f"oracle by rtol {float(rel.max())}")
        scale = (xq.scale.cpu().numpy().astype(np.float64)
                 * wq.scale.cpu().numpy().astype(np.float64))
        tol = k3_int_tol(k, LINEAR_BITS) * scale + 1e-6 * np.abs(oracle)
        k3_err = np.abs(y3 - oracle)
        check(np.all(k3_err <= tol),
              f"Engine.linear pim use_pallas=True at {name} is outside "
              f"its float32 bound: {float((k3_err / tol).max())} of it")
        # The tight check: Engine.linear's zero-point formula over the
        # plain K3 on the layer's own operands, within phase 7's rtol
        # 1e-4 of the summed terms' scale (|xq| @ |wf|) sx sw.
        wf = wq.q.float()
        twin = bitserial_matmul_ref(xq.q, wf, LINEAR_BITS)
        corr = (xq.zero * wf.sum(0, keepdim=True)
                + wq.zero * xq.q.float().sum(1, keepdim=True)
                - k * xq.zero * wq.zero)
        twin = ((twin - corr) * xq.scale * wq.scale).double().cpu().numpy()
        terms = (xq.q.double() @ wf.double()).cpu().numpy() * scale
        twin_err = np.abs(y3 - twin)
        twin_share = float((twin_err / (K3_RTOL * terms)).max())
        check(twin_share <= 1.0,
              f"Engine.linear pim use_pallas=True at {name} is off the "
              f"plain K3 path: {twin_share} of rtol 1e-4 of its terms")
        del wf, twin, terms
        phase("linear", layer=name, shape=f"{tokens}x{k}x{n}",
              exact_rtol=float(rel.max()),
              k3_max_abs_err=float(k3_err.max()),
              k3_err_share_of_bound=float((k3_err / tol).max()),
              k3_err_vs_plain_share_of_tol=twin_share,
              k3_err_share_of_max_y=float(k3_err.max()
                                          / np.abs(oracle).max()),
              exact_wall_ms=round(t_exact * 1e3, 3),
              k3_wall_ms=round(t_k3 * 1e3, 3))
        del x, w, xq, wq
    launches = bitserial_matmul.launches
    check(launches == calls, f"Engine.linear(use_pallas=True) made "
                             f"{launches} K3 launches in {calls} calls")
    return {"launches": launches, "calls": calls}


def ragged_phase(eng, dev, tokens: int, moe: dict, seed: int) -> None:
    """Phase 9: Engine.ragged_linear(mode="pim") against a host float64
    per-segment oracle, with seeded expert counts that sum to T."""
    from repro_torch.pim.quant import quantize
    rng = np.random.default_rng(seed)
    e, d, f = moe["experts"], moe["d"], moe["f"]
    t = tokens * moe["top_k"]
    counts = rng.multinomial(t, np.full(e, 1.0 / e))
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((t, d), generator=gen, device=dev)
    we = torch.randn((e, d, f), generator=gen, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    y = eng.ragged_linear(xs, we, counts.tolist(), n_bits=LINEAR_BITS,
                          mode="pim")
    sync(dev)
    wall = time.perf_counter() - t0
    check(y.device == xs.device and tuple(y.shape) == (t, f),
          "ragged_linear: wrong device or shape")
    y = y.cpu().numpy().astype(np.float64)
    xq, wq = quantize(xs, LINEAR_BITS), quantize(we, LINEAR_BITS)
    xi = xq.q.cpu().numpy().astype(np.float64) - xq.zero
    wi = wq.q.cpu().numpy().astype(np.float64) - wq.zero
    sc = float(xq.scale) * float(wq.scale)
    worst = 0.0
    lo = 0
    for ex, c in enumerate(counts):
        want = (xi[lo:lo + c] @ wi[ex]) * float(xq.scale) * float(wq.scale)
        got = y[lo:lo + c]
        check(np.all(np.abs(got - want) <= 1e-6 * np.abs(want)),
              f"ragged_linear expert {ex} is off the float64 oracle")
        if c:
            worst = max(worst, float((np.abs(got - want)
                                      / np.maximum(np.abs(want), sc))
                                     .max()))
        lo += c
    phase("ragged_linear", rows=t, d=d, f=f, experts=e,
          counts_min=int(counts.min()), counts_max=int(counts.max()),
          rtol=worst, wall_ms=round(wall * 1e3, 3))


def report_fields(rep) -> dict:
    """The serve metrics of one LoadReport, for a phase line."""
    s = rep.summary()
    return {"tokens_per_s": s["tokens_per_s"], "wall_s": s["wall_s"],
            "requests": s["n_requests"], "tokens": s["n_tokens"],
            "passes": rep.passes, "steps": rep.steps,
            "recompiles": rep.recompiles, "bit_exact": rep.bit_exact,
            "ttft_p50_us": round(s["ttft_p50_us"], 1),
            "ttft_p99_us": round(s["ttft_p99_us"], 1),
            "token_p50_us": round(s["token_p50_us"], 1),
            "token_p99_us": round(s["token_p99_us"], 1)}


def serve_trace(n_requests: int, rate: float):
    """The seeded Poisson trace of the serve phases (seed 0)."""
    from repro_torch.serve import TrafficConfig, generate
    return generate(TrafficConfig(n_requests=n_requests, rate=rate,
                                  n_bits=SERVE_BITS, seed=0))


def serve_compare_phase(spec: str, n_requests: int, rate: float) -> int:
    """Phase 10: compare_modes on ``spec``; hard checks tokens_match,
    bit_exact and zero recompiles in every mode and K1 launches in every
    mode. Returns the K1 launches of the three modes."""
    from repro_torch.engine import Engine
    from repro_torch.kernels.crossbar_step import crossbar_run_packed
    from repro_torch.serve import compare_modes, harness
    per_mode = {}
    run_load = harness.run_load

    def counted(engine, reqs, **kw):
        k0 = crossbar_run_packed.launches
        rep = run_load(engine, reqs, **kw)
        per_mode[kw["mode"]] = crossbar_run_packed.launches - k0
        return rep

    crossbar_run_packed.launches = 0
    harness.run_load = counted       # compare_modes calls run_load thrice
    try:
        res = compare_modes(Engine(spec), serve_trace(n_requests, rate),
                            n_bits=SERVE_BITS)
    finally:
        harness.run_load = run_load
    launches = crossbar_run_packed.launches
    check(res["tokens_match"], "serve_compare: tokens differ from the "
                               "reference in some mode")
    for mode in ("continuous", "roundtrip", "serial"):
        rep = res[mode]
        check(rep.bit_exact and rep.recompiles == 0
              and rep.n_requests == n_requests,
              f"serve_compare {mode}: bit_exact={rep.bit_exact} "
              f"recompiles={rep.recompiles} served={rep.n_requests}")
        check(per_mode.get(mode, 0) > 0,
              f"serve_compare {mode}: K1 never launched")
        phase("serve_compare", mode=mode, backend=spec,
              k1_launches=per_mode[mode], **report_fields(rep))
    phase("serve_compare", speedup_over_serial=round(res["speedup"], 3),
          speedup_over_roundtrip=round(res["resident_speedup"], 3),
          tokens_match=res["tokens_match"], k1_launches=launches)
    return launches


def serve_unpacked_phase(spec: str, n_requests: int, rate: float) -> int:
    """Phase 11: continuous serving on ``spec`` (``pack=false``: the
    round-trip path through K2), bit-exact. Returns the K2 launches."""
    from repro_torch.engine import Engine
    from repro_torch.kernels.crossbar_step import (crossbar_run,
                                                   crossbar_run_packed)
    from repro_torch.serve import run_load
    crossbar_run.launches = 0
    crossbar_run_packed.launches = 0
    rep = run_load(Engine(spec), serve_trace(n_requests, rate),
                   n_bits=SERVE_BITS)
    k2, k1 = crossbar_run.launches, crossbar_run_packed.launches
    check(rep.bit_exact and rep.recompiles == 0
          and rep.n_requests == n_requests,
          f"serve_unpacked: bit_exact={rep.bit_exact} recompiles="
          f"{rep.recompiles} served={rep.n_requests}")
    check(k2 == rep.passes > 0 and k1 == 0,
          f"serve_unpacked: K2 {k2} launches for {rep.passes} passes, "
          f"K1 {k1}")
    phase("serve_unpacked", backend=spec, k2_launches=k2,
          **report_fields(rep))
    return k2


def serve_device_phase(spec: str, device_config: str, n_requests: int,
                       rate: float, dev) -> int:
    """Phase 12: the device-scaled slot budget (top rung x crossbars),
    continuous, bit-exact with zero recompiles; an untraced run, then a
    traced one for the span split. Returns the untraced run's K1
    launches."""
    from repro_torch import obs
    from repro_torch.compiler.cache import compile_cached
    from repro_torch.device import DeviceConfig
    from repro_torch.engine import Engine
    from repro_torch.kernels.crossbar_step import crossbar_run_packed
    from repro_torch.pim import plan_serve_slots
    from repro_torch.serve import run_load
    eng = Engine(spec)
    device = DeviceConfig.parse(device_config, crossbar=eng.crossbar)
    slots = plan_serve_slots(eng, SERVE_BITS, device=device)
    lanes = slots.max_slots
    check(lanes == slots.ladder[-1] * device.n_crossbars,
          f"serve_device: {lanes} slots on {device}")
    reqs = serve_trace(n_requests, rate)
    crossbar_run_packed.launches = 0
    rep = run_load(eng, reqs, n_bits=SERVE_BITS, max_slots=lanes)
    launches = crossbar_run_packed.launches
    check(rep.bit_exact and rep.recompiles == 0
          and rep.n_requests == n_requests and launches > 0,
          f"serve_device: bit_exact={rep.bit_exact} recompiles="
          f"{rep.recompiles} served={rep.n_requests} K1={launches}")
    # The traced run: span seconds by name (K1's span holds its
    # enqueue; the card is waited for in backend.unpack's copy).
    tracer = obs.get_tracer()
    tracer.reset()
    tracer.enable()
    traced = run_load(eng, reqs, n_bits=SERVE_BITS, max_slots=lanes)
    tracer.disable()
    events = [e for e in tracer.trace_dict()["traceEvents"]
              if e.get("ph") == "X"]
    tracer.reset()
    check(traced.bit_exact and traced.recompiles == 0,
          "serve_device: the traced run is not bit-exact")
    spans = {}
    for e in events:
        spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
    # K1's device time per pass at these lanes (CUDA events; comparison
    # launches, after the count was read), times the untraced run's
    # passes: mac every pass, stage on all but the chain's first, recomb
    # at each drain. The run's launches are warmup's 4 (mac; stage, mac;
    # recomb), 2 passes - 1 and one per drain.
    drains = launches - 4 - (2 * rep.passes - 1)
    words = -(-lanes // 32)
    per = {}
    for kind in ("multpim_mac", "stage", "recomb"):
        packed = compile_cached(kind, SERVE_BITS).packed
        st = torch.zeros((words, packed.init_mask.shape[1]),
                         dtype=torch.int32, device=dev)
        per[kind] = time_ms(lambda: crossbar_run_packed(st, packed), 3, 20)
    kernel_s = (rep.passes * per["multpim_mac"]
                + (rep.passes - 1) * per["stage"]
                + drains * per["recomb"]) / 1e3
    phase("serve_device", backend=spec, device=str(device),
          crossbars=device.n_crossbars, lanes=lanes, k1_launches=launches,
          drains=drains, **report_fields(rep))
    phase("serve_device_split",
          k1_ms_per_pass=json.dumps({k: round(v, 5)
                                     for k, v in per.items()}),
          k1_device_s=round(kernel_s, 5),
          host_rest_s=round(rep.wall_s - kernel_s, 4),
          traced_wall_s=round(traced.wall_s, 4),
          traced_passes=traced.passes, traced_steps=traced.steps,
          span_s=json.dumps({k: round(v, 4)
                             for k, v in sorted(spans.items())}))
    return launches


def serve_faults_phase(backend: "str | None", dev) -> int:
    """Phase 13: the reference CI's gated fault runs through the
    launcher on the port's default engine (``backend`` None) or
    ``backend``, and the faulty one at full size; the faulty pass's
    time; then a fault-free resident chain with detection forced on.
    Returns the K1 launches of the fault-free runs."""
    from repro_torch import obs
    from repro_torch.compiler.cache import compile_cached
    from repro_torch.engine import Engine
    from repro_torch.faults import FaultModel
    from repro_torch.kernels.crossbar_step import crossbar_run_packed
    from repro_torch.kernels.ref import crossbar_run_ref_packed_faulty
    from repro_torch.launch import serve as launcher
    total = 0
    ci = ["--traffic", str(SERVE_REQUESTS), "--traffic-rate",
          str(SERVE_RATE)]
    full = ["--traffic", str(DEVICE_REQUESTS), "--traffic-rate",
            str(DEVICE_RATE), "--device-config", DEVICE_CONFIG]
    gated = ["--pim-bits", str(SERVE_BITS), "--fault-check", "--watchdog",
             str(WATCHDOG_S)]
    if backend is not None:
        gated += ["--pim-backend", backend]
    flips = ["--fault-rate", f"{FAULT_RATE:g}", "--fault-seed", "0"]
    for trace, extra in ((ci, []), (ci, flips), (full, flips)):
        obs.reset_metrics()
        crossbar_run_packed.launches = 0
        crossbar_run_ref_packed_faulty.calls = 0
        rep = launcher.main(trace + extra + gated)  # raises if a gate fails
        launches = crossbar_run_packed.launches
        faulty = crossbar_run_ref_packed_faulty.calls
        c = obs.dump()["counters"]
        check(rep.bit_exact and rep.recompiles == 0 and not rep.aborted
              and rep.n_requests == int(trace[1]),
              f"serve_faults {extra}: bit_exact={rep.bit_exact} "
              f"recompiles={rep.recompiles} aborted={rep.aborted}")
        check((launches > 0) == (not extra) and (faulty > 0) == bool(extra),
              f"serve_faults {extra}: K1 {launches} launches, {faulty} "
              f"faulty passes")
        total += launches
        phase("serve_faults", fault_rate=extra[1] if extra else 0,
              device=DEVICE_CONFIG if trace is full else "one crossbar",
              k1_launches=launches, faulty_passes=faulty,
              counters=json.dumps({k: v for k, v in sorted(c.items())
                                   if k.startswith(("faults.",
                                                    "serve.fault.",
                                                    "serve.rejected",
                                                    "serve.watchdog"))}),
              **report_fields(rep))
    # The faulty pass alone (CUDA events): the mac program over the serve
    # slots' one word and over serve_device's 256 words, on a model of
    # the same rate that serves nothing.
    packed = compile_cached("multpim_mac", SERVE_BITS).packed
    model = FaultModel(key="chip-smoke-timing", seed=1, p_flip=FAULT_RATE)
    for lanes in (8, DEVICE_REQUESTS):
        words = -(-lanes // 32)
        st = torch.zeros((words, packed.init_mask.shape[1]),
                         dtype=torch.int32, device=dev)
        faulty_ms = time_ms(lambda: crossbar_run_ref_packed_faulty(
            st, packed, model, lanes), 2, 10)
        k1_ms = time_ms(lambda: crossbar_run_packed(st, packed), 3, 20)
        phase("serve_faults", faulty_pass_ms=faulty_ms, k1_pass_ms=k1_ms,
              program="multpim_mac", n=SERVE_BITS, words=words,
              lanes=lanes, cycles=packed.n_cycles)
    # Detection armed without faults: K1 runs the residue program at
    # each drain, and the chain stays exact.
    eng = Engine(backend or "torch:pack=true")
    rex = eng.resident(SERVE_BITS, rows=DEVICE_REQUESTS, detect=True)
    rng = np.random.default_rng(13)
    want = np.zeros(DEVICE_REQUESTS, dtype=object)
    crossbar_run_packed.launches = 0
    for step in range(4):
        a = rng.integers(0, 1 << (SERVE_BITS - 2), DEVICE_REQUESTS)
        b = rng.integers(0, 1 << (SERVE_BITS - 2), DEVICE_REQUESTS)
        rex.step(a, b)
        want += a.astype(object) * b.astype(object)
    got = rex.drain()
    launches = crossbar_run_packed.launches
    check(launches == 1 + 2 * 3 + 2 and not rex.unrecovered.any()
          and all(int(g) == int(w) for g, w in zip(got, want)),
          f"serve_faults detect-armed chain: K1 {launches} launches "
          f"(want 9), unrecovered {int(rex.unrecovered.sum())}")
    total += launches
    phase("serve_detect", lanes=DEVICE_REQUESTS, passes=4, exact=True,
          k1_launches=launches, residue_cycles=rex.residue_entry.program
          .n_cycles)
    return total


def serve_tables(eng) -> list:
    """The n = 8 tables the serve path runs, as (name, packed, words):
    the resident chain's programs and the detect-mode residue check at
    ``serve_device``'s lanes and at one slot word, and the fused
    round-trip and serial passes (one row a slot) for each rung of the
    ladder."""
    from repro_torch.compiler.cache import compile_cached
    tables = [(kind, compile_cached(kind, SERVE_BITS).packed, words)
              for kind in ("multpim_mac", "stage", "recomb", "residue")
              for words in (DEVICE_WORDS, 1)]
    tables += [(f"mac n={SERVE_BITS} x{k} fused",
                eng.compile_batch("mac", SERVE_BITS, k).packed, 1)
               for k in eng.k_ladder("mac", SERVE_BITS)]
    return tables


def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the host)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


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


def smem_floor_ms(packed, words: int, sm_clock_hz: float) -> float:
    """K1's shared-memory floor for one pass over ``words``: the real
    ops' warp-wide accesses (K1_SMEM_ACCESSES_PER_OP per op per 32
    words) over SMS SMs at one a clock."""
    real_ops = int((np.asarray(packed.gate_id) != 0).sum())
    wavefronts = real_ops * K1_SMEM_ACCESSES_PER_OP * -(-words // 32)
    return wavefronts / (SMS * sm_clock_hz) * 1e3


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


def dup_write_tables():
    """Tables where two ops of one cycle write one column: two NOTs that
    read columns 0 and 1 and both write column 2 (column 3 scratch), and
    random gates over 24 columns whose outputs fall in 8 columns (the
    tables of tests/_tables.py). A cycle ANDs every write into its
    column."""
    from repro_torch.convert import packed_from_arrays
    gate = np.full((1, 2), 1, np.int32)                 # NOT, NOT
    ins = np.full((1, 2, 3), 3, np.int32)
    ins[0, :, 0] = [0, 1]
    two_nots = packed_from_arrays(gate, ins, np.array([[2, 2]], np.int32),
                                  np.zeros((1, 4), bool))
    rng = np.random.default_rng(11)
    t, m, c = 30, 10, 24
    gate = rng.integers(0, 7, (t, m)).astype(np.int32)
    ins = rng.integers(0, c - 1, (t, m, 3)).astype(np.int32)
    out = rng.integers(0, 8, (t, m)).astype(np.int32)
    out[gate == 0] = c - 1
    init = rng.random((t, c)) < 0.05
    init[:, c - 1] = False
    return {"two NOTs into one column": two_nots,
            "random, outputs in 8 columns": packed_from_arrays(
                gate, ins, out, init)}


def held_table():
    """A random table whose cycles read columns they write (K1's and K2's
    held path), as tests/_tables.py builds it."""
    from repro_torch.convert import packed_from_arrays
    rng = np.random.default_rng(3)
    t, m, c = 40, 12, 60
    gate = rng.integers(0, 7, (t, m)).astype(np.int32)
    ins = rng.integers(0, c - 1, (t, m, 3)).astype(np.int32)
    out = np.stack([rng.permutation(c - 1)[:m] for _ in range(t)]
                   ).astype(np.int32)
    out[gate == 0] = c - 1
    init = rng.random((t, c)) < 0.05
    init[:, c - 1] = False
    return packed_from_arrays(gate, ins, out, init)


def span_seconds(tracer) -> dict:
    """Seconds per span name in the tracer's complete events."""
    out = {}
    for e in tracer.trace_dict()["traceEvents"]:
        if e.get("ph") == "X":
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return out


def main() -> None:
    """Run every phase on card 0; raise on the first failure."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    sm_clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]) * 1e6
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
        floor = smem_floor_ms(packed, WORDS, sm_clock_hz)
        k1_rows.append({"shape": [WORDS, c], "ms": ms, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by})
        phase("K1", program=name, words=WORDS, cols=c, exact=True,
              macro="1,8", ms=ms, plain_ms=plain, bound_ms=bms,
              bound_by=by, smem_floor_ms=floor,
              sm_clock_mhz=sm_clock_hz / 1e6)
        del st, got, want
    # The fused table of two co-scheduled N = 32 MACs (C = 855, 64 ops a
    # cycle): a comparison launch, outside the main path's counts.
    fused = Engine("torch:pack=true").compile_batch("mac", N_BITS, 2).packed
    c = fused.init_mask.shape[1]
    st = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (COSCHED_ROWS, c), dtype=np.int64
    ).astype(np.int32)).to(dev)
    got = crossbar_run_packed(st, fused)
    want = crossbar_run_ref_packed(st, fused)
    torch.cuda.synchronize()
    k1_err = max(k1_err, max_abs_err(got, want))
    check(torch.equal(got, want), "K1 disagrees with its plain version on "
                                  "the co-scheduled mac N=32 k=2 table")
    ms = time_ms(lambda: crossbar_run_packed(st, fused), 3, 20)
    phase("K1", program="mac N=32 x2 co-scheduled", words=COSCHED_ROWS,
          cols=c, exact=True, ms=ms,
          smem_floor_ms=smem_floor_ms(fused, COSCHED_ROWS, sm_clock_hz))
    del st, got, want
    # Two ops of one cycle write one column: K1's held path against the
    # plain version, which ANDs every write (comparison launches).
    dups = dup_write_tables()
    for name, packed in dups.items():
        st = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (1000, packed.init_mask.shape[1]),
            dtype=np.int64).astype(np.int32)).to(dev)
        got = crossbar_run_packed(st, packed)
        want = crossbar_run_ref_packed(st, packed)
        torch.cuda.synchronize()
        k1_err = max(k1_err, max_abs_err(got, want))
        check(torch.equal(got, want), f"K1 disagrees with its plain version "
                                      f"on the table '{name}'")
        phase("K1", program=name, words=1000, exact=True, held=True)
    # The serve path's tables at its own shapes (comparison launches).
    serve = serve_tables(Engine("torch:pack=true"))
    for name, packed, words in serve:
        st = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (words, packed.init_mask.shape[1]),
            dtype=np.int64).astype(np.int32)).to(dev)
        got = crossbar_run_packed(st, packed)
        for macro in (1, 8):
            want = crossbar_run_ref_packed(st, packed, macro=macro)
            torch.cuda.synchronize()
            k1_err = max(k1_err, max_abs_err(got, want))
            check(torch.equal(got, want),
                  f"K1 disagrees with its plain version on the serve table "
                  f"{name} at {words} words macro={macro}")
        phase("K1", program=name, n=SERVE_BITS, words=words,
              cols=packed.init_mask.shape[1], exact=True, macro="1,8",
              ms=time_ms(lambda: crossbar_run_packed(st, packed), 3, 20))
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
    # The co-scheduled table (855 columns), a held table at a ragged row
    # count and the duplicate-write tables (comparison launches).
    for name, packed, rows in (
            ("mac N=32 x2 co-scheduled", fused, COSCHED_ROWS),
            ("held", held_table(), 100_003),
            *[(n, p, 70_001) for n, p in dups.items()]):
        sb = torch.from_numpy(rng.integers(
            0, 2, (rows, packed.init_mask.shape[1]), dtype=np.uint8)).to(dev)
        got = crossbar_run(sb, packed)
        want = crossbar_run_ref(sb, packed)
        torch.cuda.synchronize()
        k2_err = max(k2_err, max_abs_err(got, want))
        check(torch.equal(got, want), f"K2 disagrees with its plain version "
                                      f"on the table '{name}'")
        phase("K2", program=name, rows=rows, cols=packed.init_mask.shape[1],
              exact=True, ms=time_ms(lambda: crossbar_run(sb, packed), 2, 5))
        del sb, got, want
    # The fused serve tables at the round-trip passes' rows.
    for name, packed, _ in serve:
        if "fused" not in name:
            continue
        for rows in (1, 8):
            sb = torch.from_numpy(rng.integers(
                0, 2, (rows, packed.init_mask.shape[1]),
                dtype=np.uint8)).to(dev)
            got = crossbar_run(sb, packed)
            want = crossbar_run_ref(sb, packed)
            torch.cuda.synchronize()
            k2_err = max(k2_err, max_abs_err(got, want))
            check(torch.equal(got, want), f"K2 disagrees with its plain "
                                          f"version on {name} at {rows} rows")
            phase("K2", program=name, rows=rows,
                  cols=packed.init_mask.shape[1], exact=True)
            del sb, got, want
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 5. front door ----
    main_launches = {"K1": 0, "K2": 0}
    a = rng.integers(0, 1 << N_BITS, ROWS, dtype=np.uint64)
    b = rng.integers(0, 1 << N_BITS, ROWS, dtype=np.uint64)
    exact = a * b                       # < 2^64: exact in uint64
    tracer = obs.get_tracer()
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
        # The split, from a second run with tracing on (the wall above
        # is untraced). With pack=false the backend.kernel span holds
        # both copies and K2; with pack=true it holds only K1's enqueue,
        # and K1 runs inside backend.unpack's copy, so no rest is given.
        tracer.reset()
        tracer.enable()
        t0 = time.perf_counter()
        out = exe.run({"a": a, "b": b})["out"]
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
        tracer.disable()
        spans = span_seconds(tracer)
        tracer.reset()
        check(np.array_equal(out.astype(np.uint64), exact),
              f"traced front door pack={pack} products disagree with numpy")
        split = {"traced_wall_s": round(traced, 4),
                 "span_s": json.dumps({k: round(v, 4)
                                       for k, v in sorted(spans.items())})}
        if not pack:
            kernel_s = spans.get("backend.kernel", 0.0)
            split.update(kernel_span_s=round(kernel_s, 4),
                         rest_s=round(traced - kernel_s, 4))
        phase("front_door", op="multpim", n=N_BITS, rows=ROWS, pack=pack,
              exact=True, launches=counts, wall_s=round(wall, 3), **split)
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
    main_launches["K1"] += coschedule_phase(rng)
    torch.cuda.empty_cache()

    # ------------------------------------------------ 7. K3 vs its twin ----
    k3 = k3_phase(dev, TOKENS, EXACT_SHAPE, LINEAR_SHAPES, seed=7)
    torch.cuda.empty_cache()

    # ------------------------------------------------ 8. Engine.linear ----
    lin = linear_phase(Engine(), dev, TOKENS, LINEAR_SHAPES, seed=8)
    main_launches["K3"] = lin["launches"]
    torch.cuda.empty_cache()

    # ----------------------------------------- 9. Engine.ragged_linear ----
    ragged_phase(Engine(), dev, TOKENS, MOE, seed=9)
    torch.cuda.empty_cache()

    # ------------------------------------------------- 10-13. serving ----
    main_launches["K1"] += serve_compare_phase("torch:pack=true",
                                               SERVE_REQUESTS, SERVE_RATE)
    main_launches["K2"] += serve_unpacked_phase("torch:pack=false",
                                                SERVE_REQUESTS, SERVE_RATE)
    main_launches["K1"] += serve_device_phase(
        "torch:pack=true", DEVICE_CONFIG, DEVICE_REQUESTS, DEVICE_RATE, dev)
    main_launches["K1"] += serve_faults_phase(None, dev)
    check(all(main_launches[k] > 0 for k in ("K1", "K2", "K3")),
          f"a kernel of the main path never launched: {main_launches}")

    # ------------------------------------------------- 10. kernels line ----
    phase("done", seconds=round(time.perf_counter() - t_start, 1))
    k1_main = k1_rows[0]            # multpim N=32, the front door's pass
    k3_main = next(r for r in k3["rows"] if r["name"] == "ffn.gate_up")
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
        {"name": "K3 bitserial_matmul (bit-serial fixed-point matmul)",
         "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": main_launches["K3"], "max_abs_err": k3["max_abs_err"],
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "library_ms": k3_main["library_ms"],
         "library_note": "torch.matmul(x.float(), w), TF32 off",
         "shape": "x {0}x{1} int32 @ w {1}x{2} float32 ({3})".format(
             *k3_main["shape"], k3_main["name"]),
         "shapes": k3["rows"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
