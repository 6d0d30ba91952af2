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
14. ``multpim_area``: K1 (macro 1 and 8) and K2 against their plain
    versions on the ``multpim_area`` N = 32 tables (T = 867, M = 32,
    C = 368) over 2^20 rows, with CUDA-event timings, the bytes bound
    and K1's shared-memory floor, then the front door
    ``Engine("torch:pack=true").compile("multpim_area", 32).run`` over
    2^20 random 32-bit pairs against numpy's exact products;
15. ``trace_replay``: two N = 32 groups (two MACs, 855 columns; a
    multiplier and a RIME multiplier, 950), first K1 (macro 1 and 8)
    and K2 against their plain versions on each group's fused tables
    at 1,024 rows; then a ``TraceRecorder`` on ``serve_device``'s
    ``2x4x16x8`` device over three passes of each group, 1,024 rows on
    the card's default engine, every slot against numpy's exact
    products; the trace dumped, loaded and ``verify_replay``-ed through
    the host interpreter (``Engine("numpy")``), then through
    ``Engine("torch:pack=true")`` (K1) and ``Engine("torch:pack=false")``
    (K2), every D2H record checked, with the launches replay made
    counted;
16. ``block_trace``: ``charge(block_trace(plan_block(gemma2-9b with
    every PIM scope on, placed on 2x4x16x8)))`` on the card's default
    engine, with its latency, tokens/s and ``capacity(100_000)``; then
    ``disk_cache``:
    ``multpim`` N = 32 compiled cold into an empty disk cache and
    loaded by a fresh ``ProgramCache`` from disk with identical tables,
    K1 bit-exact on the loaded entry;
17. ``model_parity``: every smoke architecture of
    ``repro_torch.configs.ARCHS``, then gemma2-9b with
    ``pim_block_mode="full"`` and deepseek-moe-16b with ``"ffn"``, on the
    card's default engine against ``Engine("torch:device=cpu")`` on the
    same parameters (the port's ``Initializer``, seed 0, on the CPU,
    copied to the card): forward logits within the stated tolerance, and
    the greedy tokens of a prefill plus 4 decode steps equal;
18. ``model_consistency``: gemma2-9b at its published width and depth
    (42 layers, d_model 3584, 16 x 256 query heads, vocab 256,000),
    float, parameters drawn on the card: ``decode_step`` logits against
    ``forward``'s at each of 12 positions;
19. ``model_serve``: ``repro_torch.launch.serve.main`` in model mode,
    ``--arch gemma2-9b --pim --pim-scope full --batch 4 --prompt-len 32
    --gen 8 --trace``, twice on the card's default engine: prefill
    seconds, decode tokens/s, token latency p50/p99, zero recompiles
    during decode, no crossbar kernel launched, peak memory and the
    trace's events (each PIM projection's phase spans among them);
    tokens in range and equal across the two runs;
20. ``train_parity``: one train step (``make_train_step``, AdamW) of
    every smoke architecture, then qwen3-8b with two microbatches and
    remat and deepseek-7b with int8 error feedback, on the card's
    default engine against ``Engine("torch:device=cpu")`` on the same
    parameters (the host's init, seed 0, copied) and batches: loss,
    grad_norm, lr and the second step's loss within the stated
    tolerances;
21. ``train_overfit``: ``tests/test_system.py:19``'s recipe on the card
    (qwen3-8b smoke, remat, two microbatches, lr 3e-3, 12 steps on batch
    0): last loss < first - 0.5;
22. ``train_resume``: ``RetryingRunner`` on the card (qwen3-8b smoke,
    checkpoints every 4 steps, 10 steps, a failure injected at step 6):
    one restart, final parameters equal to an uninterrupted run's
    within rtol 1e-6;
23. ``train``: ``repro_torch.launch.train.main`` at qwen3-8b's published
    width and 12 of its 36 layers (the depth cut: 20 B of float32 state
    a parameter), ``--steps 6 --seq-len 256 --global-batch 8
    --microbatches 2 --trace --metrics``, remat on: losses finite, step
    seconds, tokens/s, peak memory, ``train.step`` events and the model
    FLOP rate against the float32 peak (8 layers if the peak passes 76
    GB, said on its own line); then one more step from the run's final
    state under ``torch.profiler``: the card's kernel seconds by kind
    (GEMM, elementwise, reductions, the rest) and their share of that
    step's wall;
24. ``dryrun``: ``repro_torch.launch.dryrun.lower_cell`` on both
    production meshes (16 x 16 and 2 x 16 x 16) for qwen3-8b x train_4k,
    deepseek-moe-16b x decode_32k and rwkv6-7b x long_500k, each rank
    0's sharded step traced in a fake world of the mesh's ranks (each
    record's rank trace and its whole-width trace in worker processes,
    six at a time: host work): each record's per-device peak GB, its
    temp beside the whole-width step's, FLOPs, bytes accessed,
    collective bytes by kind, trace seconds and whether the rank's peak
    fits the card's memory (``torch.cuda.get_device_properties(0)``);
25. ``dryrun_check``: the two decode cells one card holds whole,
    rwkv6-7b and recurrentgemma-9b x long_500k, and a train cell it
    holds, qwen3-8b at full width cut to 8 layers (its units traced at
    2, 3 and 4 and extrapolated) x 4 sequences of 1,024 tokens in 2
    microbatches, bf16 parameters and float32 AdamW state, on the card's
    own 1 x 1 mesh (``make_host_mesh()``): the record's argument bytes
    equal the bytes of what ``real_step`` builds on the card (seed 0),
    its peak is within 10% of ``torch.cuda.max_memory_allocated`` over
    four real steps (the first a warm-up) above what was allocated
    before, and its temp bytes within 10% of the most a step after the
    warm-up allocated above what was live when it began; the step's
    milliseconds (CUDA events) against its bytes bound (the argument
    bytes read once at 3.35 TB/s); then recurrentgemma-9b x long_500k
    and the qwen3-8b train cell on (1, 2): the record made in this
    process (rank 0's step in a fake world, no process group live
    here), held against ``real_step(mesh=...)`` on two gloo ranks
    sharing the card (this script's own rank entry under ``python -m
    torch.distributed.run``, started before phase 24 and run beside its
    host-side traces, waited for before the 1 x 1 steps): on each rank
    the argument bytes and the collective bytes by kind equal, peak and
    temp within 10%; step
    milliseconds printed as what they are: two ranks time-slicing one
    card, every collective through gloo on the host;
Phases 26, 28, 29 and 31 run all of a phase's sharded runs in one launch
of the ranks (this script's rank entry ``--launches`` under ``python -m
torch.distributed.run``: the launchers' ``main`` in turn in one process
group, the memory freed and the peak statistics and the kernels'
launch counts set to 0 before each).

26. ``train_sharded``: the training launcher under ``python -m
    torch.distributed.run --standalone --nproc-per-node 2`` with
    ``--dist-backend gloo``, both ranks on this one card (gloo's
    collectives on CUDA tensors first probed, ``python -m
    repro_torch.dist``: every collective the port calls must take CUDA
    tensors), at qwen3-8b's published width, 4 x 1,024 tokens in 2
    microbatches, float32, 3 steps, on the (data, model) meshes (1, 2)
    (tensor parallel) and (2, 1) (data parallel, ZeRO-1), both cut to 2
    layers, each against a one-rank run of the same launcher at
    that depth in this process: losses, lr and grad norms within 1e-5
    relative (the CPU tests' measure), each rank's placed
    parameter and AdamW bytes equal to the dry-run's
    ``train_state_bytes`` for that mesh (exact), each rank's peak
    (``max_memory_allocated`` in its own process) beside the one-rank
    run's and below it; step seconds printed as what they are: two ranks
    sharing one card, every collective through gloo on the host;
27. ``elastic_card``: ``repro_torch.launch.elastic`` under
    ``torch.distributed.run`` with 4 ranks on the card: deepseek-7b smoke
    on (2, 2) for 4 steps, checkpoint, 2 survivors re-meshed to (1, 2),
    restored, 3 more steps, against the card's uninterrupted (2, 2) run
    (1e-5 relative);
28. ``serve_sharded``: the serving launcher's model mode under ``python
    -m torch.distributed.run`` with ``--dist-backend gloo``, two ranks
    sharing the card, every projection on the PIM path (``--pim
    --pim-scope full``), batch 4, prompt 32, 8 tokens: (a) gemma2-9b at
    full width and depth on (1, 2), traced on rank 0, against the tokens
    of phase 19's one-rank run; (b)
    granite-20b at full width (one KV head: its caches split over the
    sequence) cut to 4 of 52 layers on (1, 2) and (c) gemma2-9b cut to
    6 layers on (2, 1), each against a one-rank run of the launcher at
    that depth in this process (freed before the ranks start): tokens
    equal, 0 recompiles during decode on every rank, each rank's placed
    parameter and decode-state bytes equal to the dry-run's count for
    its mesh, each rank's peak beside one rank's, and prefill seconds,
    decode tokens/s and token p50/p99 printed as what they are: two
    ranks sharing one card, every collective through gloo on the host;
29. ``tp_families``: the launchers under ``python -m
    torch.distributed.run`` with ``--dist-backend gloo`` on (1, 2), two
    ranks sharing the card, on the five families whose tensor
    parallelism came last, each against a one-rank run of the same
    launcher at that depth in this process (freed before the ranks
    start): (a) deepseek-moe-16b at full width (64 experts, top 6, 2
    shared, vocabulary 102,400) cut to 4 of 28 layers, served with every
    projection on the PIM path (experts over the model axis, their
    scales over the whole stack), traced on rank 0; (b)
    deepseek-moe-16b cut to 2 layers, trained 3 steps of
    4 x 1,024 tokens in 2 microbatches; (c) rwkv6-7b cut to 4 layers,
    (d) recurrentgemma-9b cut to 3 layers (one ``rrl`` unit) and (e)
    whisper-small at full width and depth with its frames, served: tokens
    equal (or losses, lr and grad norms within 1e-5 relative), 0
    recompiles during decode on every rank, each rank's placed bytes
    equal to the dry-run's count for its mesh, each rank's peak below
    one rank's, and the step times and tokens/s printed as what they
    are: two ranks sharing one card, every collective through gloo on
    the host;
30. ``fault_sharded``: a fault inside a sharded step (this script's
    rank entry ``--fault-rank OUT --kill``, two processes started by the
    phase with rank 0 holding the rendezvous store, so that a killed
    rank 1 leaves it standing; the fault injector and the runner are the
    CPU tests' own, ``tests/_torch_sharded_cases.py``). qwen3-8b at its
    published width cut to 2 layers on (1, 2), two gloo ranks sharing
    the card, ``RetryingRunner`` with checkpoints every 2 steps (12 B a
    parameter), steps of 2 x 128 tokens: first the unfailed steps 0-4
    without the runner and without a fence; (raise) the runner from the
    same start, rank 1 raising between two all-reduces of step 3's
    backward while rank 0 waits in one: both count one restart, restore
    step 2 and replay steps 2 and 3, and the losses and final parameters
    equal the unfailed run's exactly; (kill) a second runner from step
    4, rank 1 SIGKILLed inside step 4's forward: rank 0 raises
    ``RanksLost`` naming it, re-meshes alone (``elastic_remesh``, 1 x
    1), restores step 4 and trains it within 1e-5 relative of the
    unfailed loss. The recovery's seconds and the time to notice the
    lost rank are printed beside the group timeout;
31. ``tp_heads_whole``: whisper-small (12 heads) at full width on (1,
    8), eight gloo ranks sharing the card (both launchers in one launch
    of the ranks): a rank's 96 columns of each attention
    projection cut a head, so every rank runs the attention over all
    heads. Both launchers cut to 4 of 12 decoder and 4 of 12 encoder
    layers: the serving launcher (4 tokens after a prompt of 32, tokens
    equal to one rank's in this process, 0 recompiles on every rank),
    then the training launcher (2 steps of 2 x 128 tokens: losses, lr
    and grad norms within 1e-5 relative of one rank's); each rank's
    peak printed beside one rank's;
32. one JSON line describing each kernel;
33. ``{"ok": true, "device": {...}}`` as the last line.

The launch counts of the kernels' wrappers are set to 0 just before each
path of phases 5, 6, 8, 10-13, 14's front door, 15's recording and
replays and each run of 19, 28 and 29 (in the ranks' processes, before
each launcher's ``main``), and read just after (rank 0 writes its count
into the launcher's ``--summary``) (one K3 launch per
``use_pallas=True`` call, one K1 or K2 launch per fused pass, resident
program pass or replayed EXEC); comparison launches of phases 3, 4, 7,
12's timing, 14, 15's group tables and 16 do not count (17, 18 and
20-27, 28's runs (b) and (c), 29's (b) to (e), 30 and 31 launch no
kernel: the
model path takes the integer products with torch matmuls, as the
reference takes them in XLA, training runs the
float path, whose gradients the reference takes in XLA too, and the
dry-run traces fake tensors and checks itself on the float path). The
program cache spills to an empty directory under ``build/`` for the run
(``REPRO_CACHE_DIR``), removed at the end. Float32 products run without TF32
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False): K3's plain version
and the library yardstick are full float32.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# The slice of device traces: two N = 32 groups recorded on DEVICE_CONFIG
# and replayed. The reference example's MAC group, [("mac", n, 2, "w1"),
# ("mac", n, 1, "w3")], needs 3 x 427 = 1,281 columns at N = 32, more
# than a 1,024-column crossbar holds, so one copy each of w1 and w3.
REPLAY_GROUPS = ([("mac", N_BITS, 1, "w1"), ("mac", N_BITS, 1, "w3")],
                 [("multpim", N_BITS, 1, "m"), ("rime", N_BITS, 1, "r")])
REPLAY_ROWS = 1024
REPLAY_PASSES = 3
BLOCK_ARCH = "gemma2-9b"
CAPACITY_TARGET = 100_000
# The model slice. model_parity: every smoke architecture, and two with
# PIM scopes on, card against host; float logits within rtol = atol =
# MODEL_FLOAT_TOL (float32 on both, summed in other orders), PIM logits
# within a relative norm of MODEL_PIM_REL (an activation that differs in
# its last bit can round to another 8-bit level). model_consistency:
# gemma2-9b at full width and depth, decode against forward within the
# reference's own prefill/decode tolerance. model_serve: the launcher's
# model mode at full width and depth, every projection on the PIM path.
MODEL_ARCH = "gemma2-9b"
MODEL_PIM_CASES = (("gemma2-9b", "full"), ("deepseek-moe-16b", "ffn"))
MODEL_DECODE_STEPS = 4
MODEL_FLOAT_TOL = 1e-4
MODEL_PIM_REL = 1e-3
CONSISTENCY_PROMPT = 12
CONSISTENCY_TOL = 2e-3
SERVE_BATCH = 4
SERVE_PROMPT = 32
SERVE_GEN = 8
# The training slice. train_parity: one step of each smoke architecture,
# then qwen3-8b with two microbatches and remat and deepseek-7b with int8
# error feedback, card against the CPU on the same parameters and batch:
# loss within TRAIN_LOSS_RTOL (float32 sums in another order, about 1e-6
# apart), grad_norm within TRAIN_NORM_RTOL (a sum over every gradient
# element), lr within 1e-6, and the second step's loss within
# TRAIN_NEXT_RTOL (after one step AdamW moves each parameter by about
# sign(g) * lr, so a gradient at the level of float noise may move the
# two runs' parameter apart by 2 lr). train_overfit and train_resume: the
# reference tests' recipes (tests/test_system.py:19,
# tests/test_train_infra.py:71). train: the launcher at qwen3-8b's
# published width; depth cut from 36 to TRAIN_LAYERS so that float32
# parameters, gradients, the accumulator and both moments (20 B a
# parameter) fit 80 GB; TRAIN_FALLBACK_LAYERS when the peak passes
# TRAIN_PEAK_LIMIT_GB.
TRAIN_KW = dict(lr=3e-3, warmup_steps=2, total_steps=60)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NORM_RTOL = 1e-4
TRAIN_NEXT_RTOL = 1e-4
TRAIN_ARCH = "qwen3-8b"
TRAIN_LAYERS = 12
TRAIN_FALLBACK_LAYERS = 8
TRAIN_PEAK_LIMIT_GB = 76.0
TRAIN_STEPS = 6
TRAIN_SEQ = 256
TRAIN_BATCH = 8
TRAIN_MICROBATCHES = 2
# The dry-run slice. dryrun: records of a train, a MoE decode and a
# long-context cell on both production meshes. dryrun_check: the decode
# cells one card holds whole (bf16 parameters of about 14.5 and 18.8 GB,
# small recurrent and windowed states) and a train cell cut in depth,
# their record on the card's own 1 x 1 mesh against real steps: argument
# bytes equal, peak and temp bytes each within DRYRUN_RTOL of the
# measured. The train cell is (arch, layers, seq_len, batch,
# microbatches).
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("deepseek-moe-16b", "decode_32k"),
                ("rwkv6-7b", "long_500k"))
DRYRUN_CHECK_CELLS = (("rwkv6-7b", "long_500k"),
                      ("recurrentgemma-9b", "long_500k"))
DRYRUN_TRAIN_CHECK = ("qwen3-8b", 8, 1024, 4, 2)
DRYRUN_RTOL = 0.10
DRYRUN_STEPS = 4
# The same check for a rank of (1, 2): two gloo ranks sharing the card
# run real_step(mesh=...) through this script's rank entry, against the
# record of rank 0 traced in a fake world in this process.
DRYRUN_RANK_MESH = (1, 2)
DRYRUN_RANK_CELLS = (("recurrentgemma-9b", "long_500k"),)
# Phase 24's worker processes (two of the card's host cores stay for the
# ranks of phase 25, which run beside it).
DRYRUN_WORKERS = 6
# The sharded training slice: the launcher on two ranks sharing the card
# (gloo) at qwen3-8b's published width, against one rank, on (data,
# model) meshes. ZeRO-1 on (2, 1) moves every gradient and parameter through
# gloo each step (about 50 s a step at 8 layers on the shared card,
# PERF.md section 6): both meshes run cut to 2 layers, in one launch of
# the ranks, so that the script keeps its time beside the dry-run's rank
# checks.
TRAIN_SHARDED_MESHES = ((1, 2), (2, 1))
TRAIN_SHARDED_LAYERS = 2
TRAIN_SHARDED_ARGS = ["--arch", "qwen3-8b", "--steps", "3", "--seq-len",
                      "1024", "--global-batch", "4", "--microbatches", "2"]
TRAIN_SHARDED_LOSS_RTOL = 1e-5
TRAIN_SHARDED_NORM_RTOL = 1e-5
RANKS_TIMEOUT_S = 420
# The sharded serving slice: the serve launcher on two ranks sharing the
# card (gloo), every projection on the PIM path, as (run, arch, layers
# (None: all), (data, model)). Run a is held against phase 19's
# one-rank tokens; b and c against a one-rank run at their depth, cut
# so that the phase fits the script's time.
SERVE_SHARDED_RUNS = (("a", "gemma2-9b", None, (1, 2)),
                      ("b", "granite-20b", 4, (1, 2)),
                      ("c", "gemma2-9b", 6, (2, 1)))
SERVE_SHARDED_CACHE = 128            # the launcher's default --cache-len
# The tensor-parallel families: the launchers on (1, 2), two ranks
# sharing the card (gloo), each against a one-rank run at that depth in
# this process, as (run, launcher, arch, layers (None: all), arguments).
# Serving: batch 4, prompt 32, 8 tokens; training: 3 steps of 4 x 1,024
# tokens in 2 microbatches (float32 parameters, gradients, accumulator
# and AdamW moments: 20 B a parameter on one rank). Depths are cut so
# that the script keeps its time beside the dry-run's rank checks.
TP_FAMILY_SERVE = ["--batch", str(SERVE_BATCH), "--prompt-len",
                   str(SERVE_PROMPT), "--gen", str(SERVE_GEN)]
TP_FAMILY_RUNS = (
    ("a", "serve", "deepseek-moe-16b", 4,
     TP_FAMILY_SERVE + ["--pim", "--pim-scope", "full"]),
    ("b", "train", "deepseek-moe-16b", 2,
     ["--steps", "3", "--seq-len", "1024", "--global-batch", "4",
      "--microbatches", "2"]),
    ("c", "serve", "rwkv6-7b", 4, TP_FAMILY_SERVE),
    ("d", "serve", "recurrentgemma-9b", 3, TP_FAMILY_SERVE),
    ("e", "serve", "whisper-small", None, TP_FAMILY_SERVE))
# A fault inside a sharded step (the rank entry --fault-rank): qwen3-8b
# at its published width cut to 2 layers on (1, 2), two gloo ranks
# sharing the card, RetryingRunner with checkpoints every 2 steps, steps
# of 2 x 128 tokens. Rank 1 raises inside step 3's backward (the run
# "raise": steps 2 and 3 replayed from the checkpoint of step 2), then,
# in a second run from step 4, is SIGKILLed inside step 4's forward (the
# run "kill"). A checkpoint is 12 B a parameter (float32 parameters and
# AdamW moments): the runs take two saves and three restores.
FAULT_LAYERS = 2
FAULT_STEP = 3                  # the raise, inside its backward
FAULT_STEPS = FAULT_STEP + 2    # the unfailed run's; the kill in the last
FAULT_DATA = dict(seq_len=128, global_batch=2)
# Heads that the model axis does not split: whisper-small (12 heads of
# 64, 768 columns) on (1, 8), eight gloo ranks sharing the card: a
# rank's 96 columns of q, k and v cut a head, so every rank runs the
# attention over all 12 heads, its activations whole on each of the
# eight. Both launchers run in one launch of the eight ranks (the
# script's rank entry), each cut to 4 of its 12 decoder and 4 of its 12
# encoder layers (over its 1,500 frames): served 4 tokens after a
# prompt of 32, trained 2 steps of 2 x 128 tokens (eight whole
# attentions at full depth and batch do not fit one card's memory).
TP_HEADS_WHOLE_RANKS = 8
TP_HEADS_WHOLE_CUT = {"n_layers": 4, "enc_layers": 4}
TP_HEADS_WHOLE_RUNS = (
    ("serve", ["--batch", str(SERVE_BATCH), "--prompt-len",
               str(SERVE_PROMPT), "--gen", "4"]),
    ("train", ["--steps", "2", "--seq-len", "128", "--global-batch", "2"]))
ELASTIC_ARGS = ["--arch", "deepseek-7b", "--smoke", "--model-parallel",
                "2", "--survivors", "2", "--steps", "4", "--more", "3"]
BUILD = Path(__file__).resolve().parent / "build"
REFERENCE_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all", "collective-permute")


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


def area_phase(rng, dev, sm_clock_hz: float) -> dict:
    """Phase 14: K1 (macro 1 and 8) and K2 against their plain versions
    on the multpim_area N = 32 tables over 2^20 rows (comparison
    launches), then the front door over 2^20 pairs (its launch counted
    from 0). Returns both kernels' rows, errors and main-path launches."""
    from repro_torch.compiler.cache import compile_cached
    from repro_torch.engine import Engine
    from repro_torch.kernels.crossbar_step import (crossbar_run,
                                                   crossbar_run_packed)
    from repro_torch.kernels.ref import (crossbar_run_ref,
                                         crossbar_run_ref_packed)
    packed = compile_cached("multpim_area", N_BITS).packed
    t, m = packed.gate_id.shape
    c = packed.init_mask.shape[1]
    tables = f"T={t},M={m},C={c}"
    st = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (WORDS, c), dtype=np.int64).astype(np.int32)
    ).to(dev)
    got = crossbar_run_packed(st, packed)
    k1_err = 0.0
    for macro in (1, 8):
        want = crossbar_run_ref_packed(st, packed, macro=macro)
        torch.cuda.synchronize()
        k1_err = max(k1_err, max_abs_err(got, want))
        check(torch.equal(got, want), f"K1 disagrees with its plain version "
                                      f"on multpim_area macro={macro}")
    ms = time_ms(lambda: crossbar_run_packed(st, packed), 3, 20)
    plain = time_ms(lambda: crossbar_run_ref_packed(st, packed, macro=8),
                    1, 3)
    bms, by = bound_ms(packed, WORDS, 4)
    k1 = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
          "smem_floor_ms": smem_floor_ms(packed, WORDS, sm_clock_hz),
          "words": WORDS}
    phase("multpim_area", kernel="K1", n=N_BITS, tables=tables,
          exact=True, macro="1,8", **k1)
    del st, got, want
    sb = torch.from_numpy(rng.integers(0, 2, (ROWS, c),
                                       dtype=np.uint8)).to(dev)
    got = crossbar_run(sb, packed)
    want = crossbar_run_ref(sb, packed)
    torch.cuda.synchronize()
    k2_err = max_abs_err(got, want)
    check(torch.equal(got, want), "K2 disagrees with its plain version on "
                                  "multpim_area")
    del got, want
    bms, by = bound_ms(packed, ROWS, 1)
    k2 = {"ms": time_ms(lambda: crossbar_run(sb, packed), 2, 10),
          "plain_ms": time_ms(lambda: crossbar_run_ref(sb, packed), 0, 2),
          "bound_ms": bms, "bound_by": by, "rows": ROWS}
    phase("multpim_area", kernel="K2", n=N_BITS, tables=tables,
          exact=True, **k2)
    del sb
    torch.cuda.empty_cache()
    # The front door over 2^20 random 32-bit pairs (the main path).
    a = rng.integers(0, 1 << N_BITS, ROWS, dtype=np.uint64)
    b = rng.integers(0, 1 << N_BITS, ROWS, dtype=np.uint64)
    exe = Engine("torch:pack=true").compile("multpim_area", N_BITS)
    crossbar_run_packed.launches = 0
    crossbar_run.launches = 0
    t0 = time.perf_counter()
    out = exe.run({"a": a, "b": b})["out"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": crossbar_run_packed.launches,
                "K2": crossbar_run.launches}
    check(launches == {"K1": 1, "K2": 0},
          f"multpim_area front door launched {launches}")
    check(np.array_equal(out.astype(np.uint64), a * b),
          "multpim_area front door products disagree with numpy")
    phase("multpim_area", op="multpim_area", n=N_BITS, rows=ROWS,
          pack=True, exact=True, launches=launches, wall_s=round(wall, 3),
          cycles=exe.n_cycles, memristors=exe.program.n_memristors)
    return {"k1": k1, "k2": k2, "k1_err": k1_err, "k2_err": k2_err,
            "launches": launches}


def replay_batches(eng, group, rng) -> tuple:
    """One pass's operand sets for ``group`` and each slot's (a, b):
    MAC slots as the serve path's bit planes of ``a*b + 0 + 0``,
    multipliers as 32-bit integers."""
    zeros = np.zeros(REPLAY_ROWS, dtype=object)
    ops, pairs = [], []
    for op, n, copies, _ in group:
        for _ in range(copies):
            if op == "mac":
                a = rng.integers(0, 1 << (n - 2), REPLAY_ROWS)
                b = rng.integers(0, 1 << (n - 2), REPLAY_ROWS)
                ops.append(eng.mac_inputs(n, a, b, zeros, zeros))
            else:
                a = rng.integers(0, 1 << n, REPLAY_ROWS, dtype=np.uint64)
                b = rng.integers(0, 1 << n, REPLAY_ROWS, dtype=np.uint64)
                ops.append({"a": a, "b": b})
            pairs.append((op, n, a, b))
    return ops, pairs


def replay_products(eng, results, pairs) -> bool:
    """Every slot of a recorded pass against numpy's exact products: a
    multiplier's ``out``, and a MAC's carry-save ``s + c``."""
    for out, (op, n, a, b) in zip(results, pairs):
        if op == "mac":
            s, c = eng.mac_accumulate(n, out)
            got = [int(x) + int(y) for x, y in zip(s, c)]
        else:
            got = [int(v) for v in out["out"]]
        if got != [int(p) * int(q) for p, q in zip(a, b)]:
            return False
    return True


def replay_tables_phase(groups, rng, dev) -> dict:
    """K1 (macro 1 and 8) and K2 against their plain versions on each
    replay group's fused tables at the replay's REPLAY_ROWS rows
    (comparison launches). Returns each kernel's largest error."""
    from repro_torch.kernels.crossbar_step import (crossbar_run,
                                                   crossbar_run_packed)
    from repro_torch.kernels.ref import (crossbar_run_ref,
                                         crossbar_run_ref_packed)
    errs = {"K1": 0.0, "K2": 0.0}
    for spec, gex in zip(REPLAY_GROUPS, groups):
        packed = gex.packed
        t, c = packed.gate_id.shape[0], packed.init_mask.shape[1]
        st = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (REPLAY_ROWS // 32, c), dtype=np.int64
        ).astype(np.int32)).to(dev)
        got = crossbar_run_packed(st, packed)
        for macro in (1, 8):
            want = crossbar_run_ref_packed(st, packed, macro=macro)
            torch.cuda.synchronize()
            errs["K1"] = max(errs["K1"], max_abs_err(got, want))
            check(torch.equal(got, want), f"K1 disagrees with its plain "
                                          f"version on {spec} macro={macro}")
        sb = torch.from_numpy(rng.integers(0, 2, (REPLAY_ROWS, c),
                                           dtype=np.uint8)).to(dev)
        got = crossbar_run(sb, packed)
        want = crossbar_run_ref(sb, packed)
        torch.cuda.synchronize()
        errs["K2"] = max(errs["K2"], max_abs_err(got, want))
        check(torch.equal(got, want), f"K2 disagrees with its plain version "
                                      f"on {spec}")
        phase("trace_replay", group=spec, cycles=t, cols=c,
              words=REPLAY_ROWS // 32, rows=REPLAY_ROWS, k1_exact=True,
              macro="1,8", k2_exact=True)
    return errs


def trace_replay_phase(dev) -> dict:
    """Phase 15: K1 and K2 against their plain versions on each
    REPLAY_GROUPS group's tables; then record REPLAY_PASSES passes of
    each group on the card's default engine over DEVICE_CONFIG, every
    slot against numpy's exact products, dump and load the trace,
    verify_replay it through the host interpreter, then through a packed
    engine (K1) and an unpacked one (K2). Returns the main-path launches
    of each kernel (the recording's and each replay's, counted from 0)
    and the comparisons' largest errors."""
    from repro_torch.device import CommandTrace, DeviceConfig, TraceRecorder
    from repro_torch.engine import Engine
    from repro_torch.kernels.crossbar_step import (crossbar_run,
                                                   crossbar_run_packed)
    eng = Engine()
    device = DeviceConfig.parse(DEVICE_CONFIG, crossbar=eng.crossbar)
    rng = np.random.default_rng(15)
    groups = [eng.compile_group(g) for g in REPLAY_GROUPS]   # outside
    errs = replay_tables_phase(groups, rng, dev)
    batches = [[replay_batches(eng, g, rng) for g in REPLAY_GROUPS]
               for _ in range(REPLAY_PASSES)]
    rec = TraceRecorder(device)
    results = []
    crossbar_run_packed.launches = 0
    crossbar_run.launches = 0
    t0 = time.perf_counter()
    for per_pass in batches:
        for gex, (ops, _) in zip(groups, per_pass):
            results.append(gex.run(ops, recorder=rec))
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    total = {"K1": crossbar_run_packed.launches, "K2": crossbar_run.launches}
    passes = len(groups) * REPLAY_PASSES
    check(total == {"K1": passes, "K2": 0},
          f"trace_replay recording launched {total} for {passes} passes")
    pairs = [p for per_pass in batches for _, p in per_pass]
    check(all(replay_products(eng, r, p) for r, p in zip(results, pairs)),
          "trace_replay: a recorded slot disagrees with numpy's products")
    t0 = time.perf_counter()
    text = rec.trace.dumps()
    dump_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = CommandTrace.loads(text)
    load_s = time.perf_counter() - t0
    check(back.dumps() == text, "trace_replay: dumps(loads(text)) != text")
    execs = len(back.by_kind("EXEC"))
    d2h = len(back.by_kind("D2H"))
    check(execs == passes, f"trace_replay: {execs} EXEC records for "
                           f"{passes} passes")
    t0 = time.perf_counter()
    checked = back.verify_replay(Engine("numpy"))
    host_s = time.perf_counter() - t0
    check(checked == d2h > 0, f"trace_replay numpy: {checked} of {d2h} D2H "
                              f"records checked")
    phase("trace_replay", engine="numpy", d2h_checked=checked, exact=True,
          products_exact=True, replay_s=round(host_s, 4))
    replay = {}
    for spec, kern in (("torch:pack=true", "K1"), ("torch:pack=false", "K2")):
        replayer = Engine(spec)
        crossbar_run_packed.launches = 0
        crossbar_run.launches = 0
        t0 = time.perf_counter()
        checked = back.verify_replay(replayer)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        counts = {"K1": crossbar_run_packed.launches,
                  "K2": crossbar_run.launches}
        check(checked == d2h > 0,
              f"trace_replay {spec}: {checked} of {d2h} D2H records checked")
        check(counts[kern] == execs and sum(counts.values()) == execs,
              f"trace_replay {spec}: launches {counts} for {execs} EXECs")
        total[kern] += counts[kern]
        replay[kern] = {"launches": counts[kern], "replay_s": replay_s}
        phase("trace_replay", engine=spec, d2h_checked=checked,
              exact=True, launches=counts, replay_s=round(replay_s, 4))
    phase("trace_replay", device=str(device), groups=len(groups),
          passes=passes, rows=REPLAY_ROWS, records=len(back.records),
          text_bytes=len(text.encode()), record_s=round(record_s, 4),
          dump_s=round(dump_s, 4), load_s=round(load_s, 4),
          host_replay_s=round(host_s, 4),
          k1_replay_launches=replay["K1"]["launches"],
          k2_replay_launches=replay["K2"]["launches"],
          k1_replay_s=round(replay["K1"]["replay_s"], 4),
          k2_replay_s=round(replay["K2"]["replay_s"], 4))
    return {"launches": total, "errs": errs}


def block_trace_phase() -> None:
    """Phase 16a: charge a modeled gemma2-9b block (every PIM scope on)
    planned on the card's default engine and placed on DEVICE_CONFIG."""
    from repro_torch.configs import get_config
    from repro_torch.device import (CoordAllocator, DeviceConfig,
                                    block_trace, charge)
    from repro_torch.engine import Engine
    from repro_torch.pim import plan_block
    cfg = dataclasses.replace(get_config(BLOCK_ARCH), pim_linear_mode="pim",
                              pim_block_mode="full")
    eng = Engine()
    device = DeviceConfig.parse(DEVICE_CONFIG, crossbar=eng.crossbar)
    t0 = time.perf_counter()
    plan = plan_block(cfg, eng, placer=CoordAllocator(device).place)
    trace = block_trace(plan, device)
    rep = charge(trace)
    secs = time.perf_counter() - t0
    check(np.isfinite(rep.latency_us) and rep.latency_us > 0
          and rep.tokens_per_sec > 0 and rep.capacity(CAPACITY_TARGET) >= 1,
          f"block_trace: latency_us={rep.latency_us} "
          f"tokens_per_sec={rep.tokens_per_sec}")
    phase("block_trace", arch=BLOCK_ARCH, scopes=",".join(plan.scopes),
          groups=len(plan.groups), device=str(device),
          records=len(trace.records), crit_cycles=rep.crit_cycles,
          latency_us=rep.latency_us, tokens_per_sec=rep.tokens_per_sec,
          energy_uj=rep.energy_uj,
          capacity_100k=rep.capacity(CAPACITY_TARGET),
          seconds=round(secs, 4))


def disk_cache_phase(rng, dev) -> None:
    """Phase 16b: multpim N = 32 compiled cold into an empty disk cache,
    then loaded by a fresh ProgramCache from disk: identical tables, and
    K1 on the loaded entry equal to its plain version (comparison
    launch)."""
    from repro_torch.compiler import ProgramCache
    from repro_torch.kernels.crossbar_step import crossbar_run_packed
    from repro_torch.kernels.ref import crossbar_run_ref_packed
    run_dir = os.environ["REPRO_CACHE_DIR"]
    os.environ["REPRO_CACHE_DIR"] = tempfile.mkdtemp(prefix="disk-",
                                                     dir=run_dir)
    try:
        t0 = time.perf_counter()
        cold = ProgramCache(use_disk=True)
        built = cold.get_or_compile("multpim", N_BITS)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = ProgramCache(use_disk=True)
        loaded = warm.get_or_compile("multpim", N_BITS)
        load_s = time.perf_counter() - t0
    finally:
        os.environ["REPRO_CACHE_DIR"] = run_dir
    check(not built.from_disk and cold.stats()["compiles"] == 1,
          f"disk_cache: the cold compile was {cold.stats()}")
    check(loaded.from_disk and warm.stats()["disk_hits"] == 1
          and warm.stats()["compiles"] == 0 and loaded.verified.ok,
          f"disk_cache: the second cache gave {warm.stats()}")
    for name in ("gate_id", "in_cols", "out_col", "init_mask"):
        check(np.array_equal(getattr(loaded.packed, name),
                             getattr(built.packed, name)),
              f"disk_cache: loaded {name} differs from the compiled one")
    c = loaded.packed.init_mask.shape[1]
    st = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (WORDS, c), dtype=np.int64).astype(np.int32)
    ).to(dev)
    got = crossbar_run_packed(st, loaded.packed)
    want = crossbar_run_ref_packed(st, built.packed)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "disk_cache: K1 on the loaded entry "
                                  "disagrees with the plain version")
    phase("disk_cache", program="multpim", n=N_BITS, from_disk=True,
          identical_tables=True, k1_exact=True, words=WORDS,
          cold_compile_s=round(cold_s, 4), disk_load_s=round(load_s, 4))


def model_inputs(cfg, rng, batch: int, seq: int) -> "tuple[np.ndarray, dict]":
    """Seeded token ids and the stub frontends' inputs of a family."""
    tokens = rng.integers(3, cfg.vocab_size, (batch, seq))
    extra = {}
    if cfg.family == "vlm":
        extra["extra_embed"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["enc_frames"] = rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return tokens, extra


def model_parity_phase(dev) -> None:
    """Phase 17: every smoke architecture, then two with PIM scopes on,
    on the card against the port's CPU run on the same parameters (the
    port's Initializer, seed 0, on the CPU, copied to the card): forward
    logits within the stated tolerances, and the greedy tokens of a
    prefill plus MODEL_DECODE_STEPS decode steps equal."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.engine import Engine
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_map
    host, card = Engine("torch:device=cpu"), Engine()
    rng = np.random.default_rng(17)
    t_phase = time.perf_counter()
    cases = [(a, None) for a in sorted(ARCHS)] + list(MODEL_PIM_CASES)
    for arch, scope in cases:
        cfg = get_config(arch, smoke=True)
        if scope is not None:
            cfg = dataclasses.replace(cfg, pim_linear_mode="pim",
                                      pim_linear_bits=SERVE_BITS,
                                      pim_block_mode=scope)
        on_host = build_model(cfg, engine=host)
        on_card = build_model(cfg, engine=card)
        params = on_host.init(torch.Generator().manual_seed(0))
        params_card = tree_map(lambda t: t.to(dev), params)
        tokens, extra = model_inputs(cfg, rng, 2, 16)
        want, _ = on_host.forward(params, torch.from_numpy(tokens),
                                  **{k: torch.from_numpy(v)
                                     for k, v in extra.items()})
        got, _ = on_card.forward(params_card,
                                 torch.from_numpy(tokens).to(dev),
                                 **{k: torch.from_numpy(v).to(dev)
                                    for k, v in extra.items()})
        got = got.cpu()
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"model_parity {arch}: logits not finite or misshaped")
        err = float((got - want).abs().max())
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        if scope is None:
            check(torch.allclose(got, want, rtol=MODEL_FLOAT_TOL,
                                 atol=MODEL_FLOAT_TOL),
                  f"model_parity {arch}: card logits off by {err}")
        else:
            check(rel <= MODEL_PIM_REL, f"model_parity {arch} {scope}: "
                                        f"relative error {rel}")
        frames = extra.get("enc_frames")
        prompts = torch.from_numpy(tokens[:, :8])
        gen = MODEL_DECODE_STEPS + 1
        on_h = serve_model(
            on_host, params, prompts, host, gen=gen, cache_len=16,
            frames=None if frames is None else torch.from_numpy(frames))
        on_c = serve_model(
            on_card, params_card, prompts.to(dev), card, gen=gen,
            cache_len=16,
            frames=None if frames is None else torch.from_numpy(frames).to(
                dev))
        check(np.array_equal(on_h.tokens, on_c.tokens),
              f"model_parity {arch}: card tokens {on_c.tokens.tolist()} "
              f"!= host tokens {on_h.tokens.tolist()}")
        phase("model_parity", arch=arch, scope=scope or "off",
              max_abs_err=err, rel_err=rel,
              tol=(f"rtol=atol={MODEL_FLOAT_TOL}" if scope is None
                   else f"rel<={MODEL_PIM_REL}"),
              tokens_equal=True, gen=on_c.tokens.shape[1])
        del params_card
    phase("model_parity", cases=len(cases), all_equal=True,
          seconds=round(time.perf_counter() - t_phase, 1))
    torch.cuda.empty_cache()


def model_consistency_phase(dev) -> None:
    """Phase 18: MODEL_ARCH at its published width and depth, float
    (PIM off; in PIM mode the activation scale spans every row of a
    call, so prefill and decode legitimately differ): token-by-token
    decode_step logits against forward's at every position of a 1 x
    CONSISTENCY_PROMPT prompt (RoPE offsets, the ring caches at head
    size 256)."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.models import build_model
    t_phase = time.perf_counter()
    cfg = get_config(MODEL_ARCH)
    model = build_model(cfg, engine=Engine())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s = CONSISTENCY_PROMPT
    tokens = torch.from_numpy(np.random.default_rng(18).integers(
        3, cfg.vocab_size, (1, s))).to(dev)
    t0 = time.perf_counter()
    full, _ = model.forward(params, tokens)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    states = model.init_decode_state(1, 32)
    err = 0.0
    t0 = time.perf_counter()
    for t in range(s):
        logits, states = model.decode_step(
            params, tokens[:, t:t + 1],
            torch.full((1, 1), t, dtype=torch.int32, device=dev), states)
        check(torch.allclose(logits[:, 0], full[:, t],
                             rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL),
              f"model_consistency: decode differs from forward at {t}")
        err = max(err, float((logits[:, 0] - full[:, t]).abs().max()))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    phase("model_consistency", arch=cfg.name, layers=cfg.n_layers,
          d_model=cfg.d_model, heads=f"{cfg.n_heads}x{cfg.hd}",
          kv_heads=cfg.n_kv_heads, vocab=cfg.vocab_size, prompt=s,
          pim="off", max_abs_err=err,
          tol=f"rtol=atol={CONSISTENCY_TOL}", init_s=round(init_s, 3),
          forward_s=round(forward_s, 4),
          decode_ms_per_token=round(1e3 * decode_s / s, 3),
          peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
          seconds=round(time.perf_counter() - t_phase, 1))
    del params, states, full, logits
    torch.cuda.empty_cache()


def model_serve_phase(dev) -> tuple:
    """Phase 19: the launcher's model mode on the card's default engine,
    twice: MODEL_ARCH at full width and depth, every projection on the
    PIM path, traced. Checks zero recompiles during decode, no crossbar
    kernel launched, the PIM phase spans in the trace, tokens in range
    and the two runs' tokens identical. Returns the tokens and the first
    run's peak bytes."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.crossbar_step import (crossbar_run,
                                                   crossbar_run_packed)
    from repro_torch.launch import serve as launcher
    cfg = get_config(MODEL_ARCH)
    trace = BUILD / "model_serve_trace.json"
    argv = ["--arch", MODEL_ARCH, "--pim", "--pim-scope", "full",
            "--batch", str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT),
            "--gen", str(SERVE_GEN), "--trace", str(trace)]
    runs, peaks = [], []
    t_phase = time.perf_counter()
    for i in (1, 2):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        crossbar_run_packed.launches = 0
        crossbar_run.launches = 0
        t0 = time.perf_counter()
        try:
            run = launcher.main(argv)
        finally:
            obs.disable()
        wall = time.perf_counter() - t0
        launches = crossbar_run_packed.launches
        check(launches == 0 and crossbar_run.launches == 0,
              f"model_serve: K1 launched {launches} times, K2 "
              f"{crossbar_run.launches}")
        events = json.loads(trace.read_text())["traceEvents"]
        spans = {}
        for e in events:
            if e.get("ph") == "X":
                spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
        check({"model.decode_step", "pim.linear", "pim.weight",
               "pim.activation", "pim.product", "pim.dequant"} <= set(spans),
              f"model_serve: spans {sorted(spans)}")
        top = dict(sorted(spans.items(), key=lambda kv: -kv[1])[:6])
        obs.reset_trace()
        trace.unlink()
        check(run.recompiles == 0, f"model_serve: {run.recompiles} "
                                   f"recompiles during decode")
        check(run.tokens.shape == (SERVE_BATCH, SERVE_GEN)
              and bool(((run.tokens >= 0)
                        & (run.tokens < cfg.vocab_size)).all()),
              f"model_serve: tokens out of range: {run.tokens.tolist()}")
        runs.append(run)
        peaks.append(torch.cuda.max_memory_allocated())
        phase("model_serve", run=i, arch=cfg.name, layers=cfg.n_layers,
              d_model=cfg.d_model, vocab=cfg.vocab_size, pim_scope="full",
              batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
              prefill_s=round(run.prefill_s, 4),
              decode_tok_s_per_seq=round(run.tokens_per_s, 3),
              decode_tok_s=round(SERVE_BATCH * run.tokens_per_s, 3),
              token_p50_us=round(run.latency_us(50), 1),
              token_p99_us=round(run.latency_us(99), 1),
              recompiles=run.recompiles,
              peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
              trace_events=len(events), wall_s=round(wall, 3),
              span_s=json.dumps({k: round(v, 4) for k, v in top.items()}))
    check(np.array_equal(runs[0].tokens, runs[1].tokens),
          "model_serve: two identical runs gave different tokens")
    phase("model_serve", identical_tokens=True,
          sample=json.dumps(runs[0].tokens[0].tolist()),
          seconds=round(time.perf_counter() - t_phase, 1))
    torch.cuda.empty_cache()
    return runs[0].tokens, peaks[0]


def train_models(cfg, dev, remat: bool = False):
    """The model of ``cfg`` on the host and on the card."""
    from repro_torch.engine import Engine
    from repro_torch.models import build_model
    return (build_model(cfg, remat=remat, engine=Engine("torch:device=cpu")),
            build_model(cfg, remat=remat, engine=Engine()))


def train_batches(cfg, steps: int, seq: int = 32, batch: int = 8) -> list:
    """``steps`` numpy batches of the synthetic stream (with the
    family's stub inputs)."""
    from repro_torch.data import DataConfig, make_batch_fn
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = (cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        extra["frames"] = (cfg.enc_frames, cfg.d_model)
    fn = make_batch_fn(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch), extra)
    return [fn(s) for s in range(steps)]


def on(dev, batch: dict) -> dict:
    """A numpy batch as tensors on ``dev``."""
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_parity_phase(dev) -> None:
    """Phase 20: one train step of each smoke architecture, then
    qwen3-8b with two microbatches and remat and deepseek-7b with int8
    error feedback, on the card's default engine against the host on the
    same parameters (the host's init, copied) and batches: loss,
    grad_norm, lr, and the second step's loss."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    cases = ([(a, 1, False, False) for a in sorted(ARCHS)]
             + [("qwen3-8b", 2, True, False), ("deepseek-7b", 1, False, True)])
    for arch, mb, remat, compress in cases:
        cfg = get_config(arch, smoke=True)
        models = train_models(cfg, dev, remat)
        steps = [make_train_step(m, AdamWConfig(**TRAIN_KW),
                                 microbatches=mb, compress_grads=compress)
                 for m in models]
        host_state = steps[0][1](0)       # the host's init_fn, seed 0
        card_state = tree_map(
            lambda t: t.detach().to(dev, copy=True).requires_grad_(
                t.requires_grad),
            host_state)
        batches = train_batches(cfg, 2)
        mets = []
        for model, (step, _, _), state in zip(models, steps,
                                              (host_state, card_state)):
            out = []
            for b in batches:
                *state, met = step(*state, on(model.device, b))
                out.append({k: float(v) for k, v in met.items()})
            mets.append(out)
        host, card = mets
        err = {k: abs(card[0][k] - host[0][k]) / abs(host[0][k])
               for k in ("loss", "grad_norm", "lr")}
        err["next_loss"] = (abs(card[1]["loss"] - host[1]["loss"])
                            / abs(host[1]["loss"]))
        check(all(np.isfinite(m["loss"]) for m in card),
              f"train_parity {arch}: loss not finite")
        check(err["loss"] <= TRAIN_LOSS_RTOL
              and err["grad_norm"] <= TRAIN_NORM_RTOL and err["lr"] <= 1e-6
              and err["next_loss"] <= TRAIN_NEXT_RTOL,
              f"train_parity {arch}: card against host {err}")
        phase("train_parity", arch=arch, microbatches=mb, remat=remat,
              compress_grads=compress, loss=card[0]["loss"],
              grad_norm=card[0]["grad_norm"], next_loss=card[1]["loss"],
              rel_err=json.dumps(err),
              tol=f"loss {TRAIN_LOSS_RTOL}, grad_norm {TRAIN_NORM_RTOL}, "
                  f"lr 1e-6, next loss {TRAIN_NEXT_RTOL}")
    phase("train_parity", cases=len(cases), all_within=True,
          seconds=round(time.perf_counter() - t_phase, 1))


def train_overfit_phase(dev) -> None:
    """Phase 21: tests/test_system.py:19's recipe on the card: qwen3-8b
    smoke, remat, two microbatches, 12 steps on batch 0; the last loss
    must be below the first minus 0.5."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-8b", smoke=True)
    model = train_models(cfg, dev, remat=True)[1]
    step, init_fn, jit_for = make_train_step(
        model, AdamWConfig(**TRAIN_KW), microbatches=2)
    state = init_fn(0)
    fixed = on(dev, train_batches(cfg, 1)[0])
    step = jit_for(state[0], fixed)
    losses = []
    for _ in range(12):
        *state, met = step(*state, fixed)
        losses.append(float(met["loss"]))
    check(losses[-1] < losses[0] - 0.5,
          f"train_overfit: losses {losses} did not drop by 0.5")
    phase("train_overfit", arch=cfg.name, microbatches=2, remat=True,
          steps=12, first=losses[0], last=losses[-1],
          losses=json.dumps([round(x, 4) for x in losses]),
          gate="last < first - 0.5",
          seconds=round(time.perf_counter() - t_phase, 1))


def train_resume_phase(dev) -> None:
    """Phase 22: RetryingRunner on the card, qwen3-8b smoke,
    checkpoints every 4 steps, 10 steps with a failure injected at step
    6: one restart, and final parameters equal to an uninterrupted run's
    within rtol 1e-6 (tests/test_train_infra.py:71)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (RetryingRunner, make_train_step,
                                   save_checkpoint)
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-8b", smoke=True)
    model = train_models(cfg, dev)[1]
    step, init_fn, _ = make_train_step(model, AdamWConfig(**TRAIN_KW))
    batches = [on(dev, b) for b in train_batches(cfg, 10)]
    root = Path(tempfile.mkdtemp(prefix="train-resume-", dir=BUILD))
    boom = {"armed": True}

    def inject(s):
        if s == 6 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated device loss")

    finals, metrics = [], []
    try:
        for name, hook in (("a", inject), ("b", None)):
            params, opt, resid = init_fn(0)
            save_checkpoint(str(root / name), 0, {"params": params,
                                                  "opt": opt})
            runner = RetryingRunner(step_fn=step,
                                    batch_fn=lambda s: batches[s],
                                    ckpt_dir=str(root / name), ckpt_every=4)
            (params, opt, _), m = runner.run((params, opt, resid), 0, 10,
                                             inject_failure=hook)
            finals.append(params)
            metrics.append(m)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(metrics[0]["restarts"] == 1 and metrics[1]["restarts"] == 0,
          f"train_resume: restarts {metrics}")
    worst = 0.0
    for a, b in zip(tree_leaves(finals[0]), tree_leaves(finals[1])):
        check(a.device == dev and a.requires_grad,
              "train_resume: a restored leaf left the card or its grad")
        check(torch.allclose(a, b, rtol=1e-6, atol=0),
              "train_resume: resumed parameters differ from the "
              "uninterrupted run's")
        worst = max(worst, float((a - b).detach().abs().max()))
    phase("train_resume", arch=cfg.name, steps=10, ckpt_every=4,
          failure_at=6, restarts=metrics[0]["restarts"],
          final_loss=metrics[0]["loss"], max_abs_diff=worst, tol="rtol=1e-6",
          seconds=round(time.perf_counter() - t_phase, 1))


def train_launch(layers: int) -> tuple:
    """One run of the training launcher at TRAIN_ARCH's published width
    and ``layers`` layers, traced; returns (run, peak bytes, trace
    events, matmul parameters)."""
    from repro_torch import obs
    from repro_torch.launch import train as launcher
    from repro_torch.tree import tree_leaves
    trace = BUILD / "train_trace.json"
    metrics = BUILD / "train_metrics.json"
    argv = ["--arch", TRAIN_ARCH, "--override",
            json.dumps({"n_layers": layers}), "--steps", str(TRAIN_STEPS),
            "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
            "--microbatches", str(TRAIN_MICROBATCHES), "--trace", str(trace),
            "--metrics", str(metrics)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs.reset_trace()
    try:
        run = launcher.main(argv)
    finally:
        obs.disable()
    peak = torch.cuda.max_memory_allocated()
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("name") == "train.step"]
    snap = json.loads(metrics.read_text())
    trace.unlink()
    metrics.unlink()
    obs.reset_trace()
    matmul = sum(p.numel() for p in tree_leaves(run.state[0])
                 if p.ndim >= 2)
    return run, peak, events, matmul, snap


def train_profile(state, layers: int, dev) -> dict:
    """One more train step from the launcher's final ``state`` (same
    model, batch 0 of its stream) under ``torch.profiler``: the wall,
    the summed time of the card's kernels by kind (GEMM, elementwise,
    reductions, the rest) and their share of the wall (one stream, so
    kernels do not overlap). The profiler's overhead lengthens the wall:
    the step time to report is ``train``'s, not this one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=layers)
    model = train_models(cfg, dev, remat=True)[1]
    step, _, _ = make_train_step(
        model, AdamWConfig(lr=3e-4, warmup_steps=50, total_steps=TRAIN_STEPS),
        microbatches=TRAIN_MICROBATCHES)
    batch = on(dev, train_batches(cfg, 1, TRAIN_SEQ, TRAIN_BATCH)[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        *state, met = step(*state, batch)
        float(met["loss"])
        wall = time.perf_counter() - t0
    kinds = {"gemm": 0.0, "elementwise": 0.0, "reduce": 0.0, "other": 0.0}
    top = []
    n = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        name = e.key.lower()
        kind = ("gemm" if "gemm" in name else
                "elementwise" if "elementwise" in name else
                "reduce" if "reduce" in name else "other")
        kinds[kind] += us / 1e6
        n += e.count
        top.append((us / 1e6, e.key[:60]))
    busy = sum(kinds.values())
    return {"wall_s": wall, "kernel_s": busy,
            "busy_share": busy / wall if busy else "not measured",
            "by_kind_s": json.dumps(kinds), "kernel_launches": n,
            "top": json.dumps(sorted(top, reverse=True)[:5])}


def train_phase(dev) -> None:
    """Phase 23: ``repro_torch.launch.train.main`` on the card's default
    engine at qwen3-8b's published width (d_model 4096, 32 x 128 query
    and 8 KV heads, d_ff 12288, vocab 151,936) and TRAIN_LAYERS of its
    36 layers, remat on, two microbatches: losses finite, step seconds
    (p50 without the first), tokens/s, peak memory, the ``train.step``
    events, and the model FLOP rate (8 x matmul parameters x tokens a
    step, with remat) against the float32 peak (TF32 off); then one
    more step under ``torch.profiler`` (``train_profile``)."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    layers = TRAIN_LAYERS
    run, peak, events, matmul, snap = train_launch(layers)
    if peak / 1e9 > TRAIN_PEAK_LIMIT_GB:
        phase("train", depth_fallback=f"{layers} layers peaked at "
              f"{peak / 1e9:.3f} GB > {TRAIN_PEAK_LIMIT_GB} GB; rerun at "
              f"{TRAIN_FALLBACK_LAYERS}")
        layers = TRAIN_FALLBACK_LAYERS
        run = None      # free the deeper run's state before the next
        run, peak, events, matmul, snap = train_launch(layers)
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=layers)
    check(len(run.losses) == TRAIN_STEPS
          and all(np.isfinite(x) for x in run.losses),
          f"train: losses {run.losses}")
    check(len(events) == TRAIN_STEPS,
          f"train: {len(events)} train.step events, not {TRAIN_STEPS}")
    prof = train_profile(run.state, layers, dev)
    run.state = ()
    p50 = statistics.median(run.step_s[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 8 * matmul * tokens
    phase("train", arch=cfg.name, layers=layers,
          layers_published=get_config(TRAIN_ARCH).n_layers,
          d_model=cfg.d_model, heads=f"{cfg.n_heads}x{cfg.hd}",
          kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
          params=cfg.param_count(), matmul_params=matmul,
          seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
          microbatches=TRAIN_MICROBATCHES, remat=True,
          losses=json.dumps(run.losses), step_s=json.dumps(run.step_s),
          step_s_p50=p50, tokens_per_s=tokens / p50,
          gauge_tokens_per_s=snap["gauges"]["train.tokens_per_sec"],
          model_tflop_per_step=flops / 1e12,
          model_tflop_s=flops / p50 / 1e12,
          fp32_peak_share=flops / p50 / OPS_PER_S,
          fp32_bound_s=flops / OPS_PER_S, peak_gb=peak / 1e9,
          train_step_events=len(events),
          seconds=round(time.perf_counter() - t_phase, 1))
    phase("train_profile", arch=cfg.name, layers=layers, **prof)
    torch.cuda.empty_cache()


def dryrun_record(arch: str, shape: str, multi_pod: bool,
                  whole: bool) -> dict:
    """One part of a record of phase 24, in a worker process of its own:
    rank 0's record (its own fake world), or its whole-width trace."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch import dryrun
    if whole:
        return dryrun.whole_width_cell(arch, shape, multi_pod=multi_pod)
    return dryrun.lower_cell(arch, shape, multi_pod=multi_pod,
                             full_width=False, verbose=False)


def dryrun_phase() -> None:
    """Phase 24: the dry-run's records of DRYRUN_CELLS on both
    production meshes, each rank's peak against the card's memory. The
    records are host work (fake tensors): each record's rank trace and
    its whole-width trace run in worker processes, DRYRUN_WORKERS at a
    time."""
    props = torch.cuda.get_device_properties(0)
    t_phase = time.perf_counter()
    phase("dryrun", card=props.name, memory_bytes=props.total_memory)
    cells = [(arch, shape, multi_pod) for arch, shape in DRYRUN_CELLS
             for multi_pod in (False, True)]
    jobs = [c + (whole,) for whole in (False, True) for c in cells]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=DRYRUN_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(dryrun_record, *zip(*jobs)))
    for (arch, shape, _), rec, whole in zip(cells, parts[:len(cells)],
                                           parts[len(cells):]):
        trace_s = rec["trace"]["seconds"] + whole.pop("seconds")
        rec["trace"].update(whole, seconds=round(trace_s, 1))
        pd = rec["per_device"]
        check(rec["status"] == "ok" and rec["flops"] > 0,
              f"dryrun: {arch} x {shape}: {rec}")
        coll = rec["collective_bytes"]
        check(rec["trace"]["per_rank"] and coll and set(coll) <= set(
            REFERENCE_COLLECTIVES), f"dryrun: {arch} x {shape}: not "
            f"a rank's record: {rec['trace']} {coll}")
        phase("dryrun", arch=arch, shape=shape, mesh=rec["mesh"],
              peak_gb=pd["peak_bytes"] / 1e9,
              argument_gb=pd["argument_bytes"] / 1e9,
              temp_gb=pd["temp_bytes"] / 1e9,
              full_width_temp_gb=rec["trace"]["full_width_temp_bytes"]
              / 1e9,
              output_gb=pd["output_bytes"] / 1e9, flops=rec["flops"],
              bytes_accessed=rec["bytes_accessed"],
              collective_bytes=json.dumps(coll),
              per_rank=rec["trace"]["per_rank"],
              trace_s=rec["trace"]["seconds"],
              units=json.dumps(rec["trace"]["units"]),
              rows=rec["trace"]["rows"],
              microbatches=rec["trace"]["microbatches"],
              fits=pd["peak_bytes"] <= props.total_memory)
    phase("dryrun", cells=len(cells), workers=DRYRUN_WORKERS,
          seconds=round(time.perf_counter() - t_phase, 1))


def dryrun_cells() -> list:
    """(config, shape, microbatches) of DRYRUN_CHECK_CELLS and of
    DRYRUN_TRAIN_CHECK."""
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    arch, layers, seq, batch, mb = DRYRUN_TRAIN_CHECK
    cells = [(get_config(a), next(s for s in SHAPES if s.name == name), 1)
             for a, name in DRYRUN_CHECK_CELLS]
    cells.append((get_config(arch).scaled(n_layers=layers),
                  ShapeSpec(f"train_{seq}", seq, batch, "train"), mb))
    return cells


def dryrun_held(name: str, rec: dict, real: dict, cfg, shape) -> tuple:
    """Hold one real step's measure against the record: argument bytes
    equal, peak and temp within DRYRUN_RTOL, sane outputs. Returns the
    peak's and the temp's relative errors."""
    pd = rec["per_device"]
    check(real["argument_bytes"] == pd["argument_bytes"],
          f"dryrun_check: {name}: predicted argument bytes "
          f"{pd['argument_bytes']} != allocated "
          f"{real['argument_bytes']}")
    rel = (pd["peak_bytes"] - real["peak_bytes"]) / real["peak_bytes"]
    check(abs(rel) <= DRYRUN_RTOL,
          f"dryrun_check: {name}: predicted peak {pd['peak_bytes']} "
          f"against measured {real['peak_bytes']} ({rel:+.4f})")
    temp_rel = (pd["temp_bytes"] - real["temp_bytes"]) / real["temp_bytes"]
    check(abs(temp_rel) <= DRYRUN_RTOL,
          f"dryrun_check: {name}: predicted temp {pd['temp_bytes']} "
          f"against measured {real['temp_bytes']} ({temp_rel:+.4f})")
    if shape.kind == "decode":
        check(all(0 <= t < cfg.vocab_size for step in real["outputs"]
                  for t in step),
              f"dryrun_check: tokens {real['outputs']}")
    else:
        check(all(np.isfinite(loss) for step in real["outputs"]
                  for loss in step),
              f"dryrun_check: losses {real['outputs']}")
    return rel, temp_rel


def dryrun_rank_cells() -> list:
    """The (config, shape, microbatches) of phase 25 checked on
    DRYRUN_RANK_MESH: DRYRUN_RANK_CELLS and DRYRUN_TRAIN_CHECK."""
    return [c for c in dryrun_cells() if (c[0].name, c[1].name) in
            DRYRUN_RANK_CELLS or c[1].kind == "train"]


def start_dryrun_ranks(out_dir: str) -> tuple:
    """Start phase 25's two gloo ranks sharing the card (this script's
    rank entry), which run the real steps of :func:`dryrun_rank_cells`
    and write them into ``out_dir``; they run beside phase 24, which is
    host work."""
    specs = [{"arch": cfg.name, "layers": cfg.n_layers,
              "shape": dataclasses.asdict(shape), "microbatches": mb,
              "model_parallel": DRYRUN_RANK_MESH[1]}
             for cfg, shape, mb in dryrun_rank_cells()]
    return start_ranks(2, "chip_smoke", ["--dryrun-rank", json.dumps(specs),
                                         out_dir])


def dryrun_check_phase(smi: str, ranks: tuple, out_dir: str) -> None:
    """Phase 25: the records of DRYRUN_CHECK_CELLS and of
    DRYRUN_TRAIN_CHECK on the 1 x 1 host mesh against real steps on the
    card, then those of :func:`dryrun_rank_cells` on DRYRUN_RANK_MESH
    against the two gloo ranks of :func:`start_dryrun_ranks` (waited for
    first: the card holds either them or the 1 x 1 steps)."""
    from repro_torch.launch.dryrun import cell_record, real_step
    from repro_torch.launch.mesh import abstract_mesh, make_host_mesh
    wall = wait_ranks(ranks)
    reals = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reals.append(json.load(f))
    mesh = make_host_mesh()
    for cfg, shape, microbatches in dryrun_cells():
        t_cell = time.perf_counter()
        rec = cell_record(cfg, shape, mesh, microbatches=microbatches)
        pd = rec["per_device"]
        gc.collect()
        torch.cuda.empty_cache()
        real = real_step(cfg, shape, microbatches=microbatches,
                         steps=DRYRUN_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
        name = f"{cfg.name} ({cfg.n_layers} layers) x {shape.name}"
        check(rec["status"] == "ok" and
              rec["trace"]["microbatches"] == microbatches,
              f"dryrun_check: {name}: {rec}")
        rel, temp_rel = dryrun_held(name, rec, real, cfg, shape)
        bound = pd["argument_bytes"] / HBM_BYTES_PER_S * 1e3
        phase("dryrun_check", arch=cfg.name, layers=cfg.n_layers,
              shape=shape.name, mesh=rec["mesh"],
              microbatches=microbatches,
              units=json.dumps(rec["trace"]["units"]),
              argument_bytes=pd["argument_bytes"],
              allocated_bytes=real["argument_bytes"],
              predicted_peak_bytes=pd["peak_bytes"],
              measured_peak_bytes=real["peak_bytes"], peak_rel_err=rel,
              predicted_temp_bytes=pd["temp_bytes"],
              measured_temp_bytes=real["temp_bytes"],
              temp_rel_err=temp_rel, flops=rec["flops"],
              trace_s=rec["trace"]["seconds"], step_ms=real["ms"],
              step_ms_each=json.dumps(real["step_ms"]),
              outputs=json.dumps(real["outputs"]),
              bytes_bound_ms=bound, bound_share=bound / real["ms"],
              card=json.dumps(smi),
              seconds=round(time.perf_counter() - t_cell, 1))
    # On a rank of (1, 2): the record in this process, in a fake world
    # (one process has one default group: none may be running here).
    check(not torch.distributed.is_initialized(),
          "dryrun_check: a process group is running in the script's "
          "process")
    ranked = dryrun_rank_cells()
    t_ranked = time.perf_counter()
    for k, (cfg, shape, microbatches) in enumerate(ranked):
        rec = cell_record(cfg, shape, abstract_mesh(DRYRUN_RANK_MESH,
                                                    ("data", "model")),
                          microbatches=microbatches)
        check(rec["status"] == "ok" and rec["trace"]["per_rank"],
              f"dryrun_check: {cfg.name} x {shape.name}: {rec}")
        pd = rec["per_device"]
        name = (f"{cfg.name} ({cfg.n_layers} layers) x {shape.name} on "
                f"{rec['mesh']}")
        for r in range(2):
            real = reals[r][k]
            rel, temp_rel = dryrun_held(f"{name}, rank {r}", rec, real,
                                        cfg, shape)
            check(real["collective_bytes"] == rec["collective_bytes"],
                  f"dryrun_check: {name}, rank {r}: traced collectives "
                  f"{rec['collective_bytes']} against measured "
                  f"{real['collective_bytes']}")
            phase("dryrun_check", arch=cfg.name, layers=cfg.n_layers,
                  shape=shape.name, mesh=rec["mesh"], rank=r, ranks=2,
                  backend="gloo (both ranks time-slice one card, every "
                          "collective through the host)",
                  microbatches=microbatches,
                  units=json.dumps(rec["trace"]["units"]),
                  argument_bytes=pd["argument_bytes"],
                  allocated_bytes=real["argument_bytes"],
                  predicted_peak_bytes=pd["peak_bytes"],
                  measured_peak_bytes=real["peak_bytes"],
                  peak_rel_err=rel,
                  predicted_temp_bytes=pd["temp_bytes"],
                  measured_temp_bytes=real["temp_bytes"],
                  temp_rel_err=temp_rel,
                  full_width_temp_bytes=rec["trace"]["full_width_temp_bytes"],
                  collective_bytes=json.dumps(rec["collective_bytes"]),
                  measured_collective_bytes=json.dumps(
                      real["collective_bytes"]),
                  flops=rec["flops"], measured_flops=real["flops"],
                  bytes_accessed=rec["bytes_accessed"],
                  trace_s=rec["trace"]["seconds"],
                  shared_card_step_ms=real["ms"],
                  step_ms_each=json.dumps(real["step_ms"]),
                  outputs=json.dumps(real["outputs"]),
                  card=json.dumps(smi))
        check(reals[0][k]["outputs"] == reals[1][k]["outputs"],
              f"dryrun_check: {name}: the ranks' outputs differ")
    phase("dryrun_check", mesh="x".join(map(str, DRYRUN_RANK_MESH)),
          cells=len(ranked), ranks_wall_s=round(wall, 1),
          records_s=round(time.perf_counter() - t_ranked, 1))


def dryrun_rank(specs: list, out_dir: str) -> None:
    """One gloo rank of phase 25's (1, 2) check, under ``python -m
    torch.distributed.run``: ``real_step(mesh=...)`` on the card for
    each spec in turn, the results as ``rank<r>.json`` in ``out_dir``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import dist
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.dryrun import real_step
    from repro_torch.launch.mesh import make_host_mesh
    rank = dist.init_distributed("gloo")
    try:
        torch.cuda.set_device(dist.local_device("cuda"))
        out = []
        for spec in specs:
            cfg = get_config(spec["arch"]).scaled(n_layers=spec["layers"])
            mesh = make_host_mesh(model_parallel=spec["model_parallel"])
            out.append(real_step(cfg, ShapeSpec(**spec["shape"]),
                                 microbatches=spec["microbatches"],
                                 steps=DRYRUN_STEPS, mesh=mesh))
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def start_ranks(nproc: int, module: str, args: list) -> tuple:
    """Start ``python -m torch.distributed.run --standalone
    --nproc-per-node nproc -m module args`` from the repo root with
    ``src`` on the path, in a session of its own; :func:`wait_ranks`
    ends it. Returns (process, start time, what it runs)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="4")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", module] + args
    proc = subprocess.Popen(cmd, cwd=str(root), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    return proc, time.perf_counter(), f"{module} on {nproc} ranks"


def wait_ranks(started: tuple, timeout: float = RANKS_TIMEOUT_S) -> float:
    """Wait for :func:`start_ranks`' run: killed with all its ranks if
    it outlives ``timeout``; raises unless it exits 0. Returns its wall
    seconds."""
    import signal
    proc, t0, what = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{what} outlived {timeout} s")
    check(proc.returncode == 0,
          f"{what} exited {proc.returncode}:\n{out[-2000:]}\n"
          f"{err[-4000:]}")
    return time.perf_counter() - t0


def run_ranks(nproc: int, module: str, args: list,
              timeout: float = RANKS_TIMEOUT_S) -> float:
    """:func:`start_ranks`, then :func:`wait_ranks`."""
    return wait_ranks(start_ranks(nproc, module, args), timeout)


def gloo_cuda_phase() -> dict:
    """Which collectives gloo takes for CUDA tensors in this torch, two
    ranks on the card: every one the port calls
    (``repro_torch.dist.COLLECTIVES``) must be, since the port stages
    none through the host by hand."""
    from repro_torch import dist
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.dist"], cwd=str(root),
        env=env, capture_output=True, text=True, timeout=180)
    check(res.returncode == 0, f"gloo_cuda: {res.stderr[-3000:]}")
    found = json.loads(res.stdout.strip().splitlines()[-1])
    refused = {k: v for k, v in found["gloo_cuda"].items() if v != "ok"}
    check(set(found["gloo_cuda"]) == set(dist.COLLECTIVES) and not refused,
          f"gloo_cuda: gloo refuses CUDA tensors for {refused}")
    phase("gloo_cuda", torch=found["torch"],
          direct=",".join(sorted(found["gloo_cuda"])), staged="none")
    return found


def one_rank_run(args: list, layers: int) -> tuple:
    """The launcher on one rank in this process: (TrainRun, peak bytes,
    wall seconds)."""
    from repro_torch.launch import train as launcher
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = launcher.main(args)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    run.state = ()
    gc.collect()
    torch.cuda.empty_cache()
    return run, peak, wall


def train_sharded_phase(smi: str) -> None:
    """Phase 26: the launcher on meshes of two ranks sharing the card
    (both in one launch of the ranks) against one rank in this process
    (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import train_state_bytes
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.model import abstract_params
    t_phase = time.perf_counter()
    layers = TRAIN_SHARDED_LAYERS
    args = TRAIN_SHARDED_ARGS + ["--override",
                                 json.dumps({"n_layers": layers})]
    cfg = get_config("qwen3-8b").scaled(n_layers=layers)
    whole = abstract_params(cfg, torch.float32)

    def count(mesh):
        return train_state_bytes(cfg, abstract_mesh(mesh, ("data", "model")),
                                 whole)
    one, one_peak, one_s = one_rank_run(args, layers)
    check(one.placed_bytes == [count((1, 1))],
          f"train_sharded: one rank placed {one.placed_bytes}, the "
          f"dry-run counts {count((1, 1))}")
    check(len(one.losses) == 3 and all(np.isfinite(one.losses)),
          f"train_sharded: one-rank losses {one.losses}")
    phase("train_sharded", mesh="1x1", ranks=1, layers=layers,
          losses=json.dumps(one.losses),
          grad_norms=json.dumps(one.grad_norms),
          lrs=json.dumps(one.lrs), placed_bytes=one.placed_bytes[0],
          peak_bytes=one_peak, step_s=json.dumps(one.step_s),
          wall_s=round(one_s, 1))
    summaries = {m: BUILD / f"train_sharded_{m[0]}x{m[1]}.json"
                 for m in TRAIN_SHARDED_MESHES}
    wall = run_launches(2, [
        ["repro_torch.launch.train", args + [
            "--model-parallel", str(tp), "--dist-backend", "gloo",
            "--summary", str(summaries[(dp, tp)])]]
        for dp, tp in TRAIN_SHARDED_MESHES])
    for dp, tp in TRAIN_SHARDED_MESHES:
        got = json.loads(summaries[(dp, tp)].read_text())
        summaries[(dp, tp)].unlink()
        name = f"{dp}x{tp}"
        check(got["mesh"] == {"data": dp, "model": tp},
              f"train_sharded: mesh {got['mesh']}")
        errs = {}
        for key, want, rtol in (
                ("losses", one.losses, TRAIN_SHARDED_LOSS_RTOL),
                ("lrs", one.lrs, TRAIN_SHARDED_LOSS_RTOL),
                ("grad_norms", one.grad_norms, TRAIN_SHARDED_NORM_RTOL)):
            errs[key] = max(abs(a - b) / abs(b)
                            for a, b in zip(got[key], want))
            check(len(got[key]) == len(want) and errs[key] <= rtol,
                  f"train_sharded {name}: {key} {got[key]} against one "
                  f"rank's {want} (relative {errs[key]} > {rtol})")
        check(got["placed_bytes"] == [count((dp, tp))] * 2,
              f"train_sharded {name}: placed {got['placed_bytes']}, the "
              f"dry-run counts {count((dp, tp))}")
        check(all(p < one_peak for p in got["peak_bytes"]),
              f"train_sharded {name}: rank peaks {got['peak_bytes']} not "
              f"below one rank's {one_peak}")
        phase("train_sharded", mesh=name, ranks=2, layers=layers,
              backend="gloo (both ranks on one card, every collective "
                      "through the host)",
              losses=json.dumps(got["losses"]),
              loss_rel_err=errs["losses"],
              grad_norm_rel_err=errs["grad_norms"],
              lr_rel_err=errs["lrs"],
              placed_bytes=json.dumps(got["placed_bytes"]),
              spec_count=count((dp, tp)),
              peak_bytes=json.dumps(got["peak_bytes"]),
              one_rank_peak=one_peak,
              step_s_shared_card=json.dumps(got["step_s"]),
              card=json.dumps(smi))
    phase("train_sharded", ranks_wall_s=round(wall, 1),
          seconds=round(time.perf_counter() - t_phase, 1))

def elastic_card_phase() -> None:
    """Phase 27: the elastic schedule on 4 ranks sharing the card."""
    t_phase = time.perf_counter()
    out = BUILD / "elastic_card.json"
    ckpt = BUILD / "elastic_card_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        wall = run_ranks(4, "repro_torch.launch.elastic", ELASTIC_ARGS + [
            "--ckpt-dir", str(ckpt), "--out", str(out)])
        got = json.loads(out.read_text())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        out.unlink(missing_ok=True)
    check(got["mesh1"] == {"data": 2, "model": 2}
          and got["mesh2"] == {"data": 1, "model": 2},
          f"elastic_card: meshes {got['mesh1']} -> {got['mesh2']}")
    check(got["restored_step"] == 4 and got["l1"] == got["r1"],
          f"elastic_card: {got}")
    err = max(abs(a - b) / abs(b) for a, b in zip(got["l2"], got["r2"]))
    check(len(got["l2"]) == 3 and err <= TRAIN_SHARDED_LOSS_RTOL,
          f"elastic_card: resumed {got['l2']} against uninterrupted "
          f"{got['r2']} ({err})")
    phase("elastic_card", arch="deepseek-7b smoke", ranks=4, mesh="2x2",
          survivors=2, remesh="1x2", l1=json.dumps(got["l1"]),
          l2=json.dumps(got["l2"]), r2=json.dumps(got["r2"]),
          rel_err=err, wall_s=round(wall, 1),
          seconds=round(time.perf_counter() - t_phase, 1))


def serve_one_rank(argv: list) -> tuple:
    """The serving launcher on one rank in this process: (GreedyRun, peak
    bytes); its memory freed after."""
    from repro_torch import obs
    from repro_torch.launch import serve as launcher
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        run = launcher.main(argv)
    finally:
        obs.disable()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return run, peak


def serve_sharded_phase(smi: str, probe: dict, one_tokens: np.ndarray,
                        one_peak: int) -> None:
    """Phase 28: the serving launcher on meshes of two ranks sharing the
    card (see the module docstring)."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _tree_bytes, abstract_states
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.model import abstract_params
    from repro_torch.train.sharding import param_shardings, state_shardings
    t_phase = time.perf_counter()
    needed = ("all_reduce_int64", "all_reduce_max", "all_gather_float64",
              "all_gather_int32")
    refused = {k: probe["gloo_cuda"].get(k, "not probed") for k in needed
               if probe["gloo_cuda"].get(k) != "ok"}
    check(not refused, f"serve_sharded: gloo refuses CUDA tensors for "
                       f"{refused}")
    runs, launches = [], []
    for run_id, arch, layers, (dp, tp) in SERVE_SHARDED_RUNS:
        cfg = get_config(arch)
        argv = ["--arch", arch, "--pim", "--pim-scope", "full",
                "--batch", str(SERVE_BATCH), "--prompt-len",
                str(SERVE_PROMPT), "--gen", str(SERVE_GEN)]
        if layers is not None:
            cfg = cfg.scaled(n_layers=layers)
            argv += ["--override", json.dumps({"n_layers": layers})]
            one, peak = serve_one_rank(argv)
            check(one.recompiles == 0, f"serve_sharded {run_id}: one rank "
                                       f"recompiled {one.recompiles}")
            want = one.tokens
            phase("serve_sharded", run=run_id, mesh="1x1", arch=cfg.name,
                  layers=cfg.n_layers, prefill_s=round(one.prefill_s, 4),
                  decode_tok_s=round(SERVE_BATCH * one.tokens_per_s, 3),
                  token_p50_us=round(one.latency_us(50), 1),
                  token_p99_us=round(one.latency_us(99), 1),
                  peak_bytes=peak)
            del one
        else:
            want, peak = one_tokens, one_peak
        trace = BUILD / f"serve_sharded_{run_id}_trace.json"
        summary = BUILD / f"serve_sharded_{run_id}.json"
        extra = ["--trace", str(trace)] if run_id == "a" else []
        launches.append(["repro_torch.launch.serve", argv + extra + [
            "--model-parallel", str(tp), "--dist-backend", "gloo",
            "--summary", str(summary)]])
        runs.append((run_id, cfg, dp, tp, want, peak, summary, trace))
    wall = run_launches(2, launches)
    for run_id, cfg, dp, tp, want, peak, summary, trace in runs:
        got = json.loads(summary.read_text())
        summary.unlink()
        spans = {}
        if trace.exists():          # rank 0's spans, the collectives' too
            for e in json.loads(trace.read_text())["traceEvents"]:
                if e.get("ph") == "X":
                    n, t = spans.get(e["name"], (0, 0.0))
                    spans[e["name"]] = (n + 1, t + e["dur"] / 1e6)
            trace.unlink()
        name = f"{dp}x{tp}"
        mesh = abstract_mesh((dp, tp), ("data", "model"))
        params = abstract_params(cfg, torch.float32)
        states = abstract_states(cfg, SERVE_BATCH, SERVE_SHARDED_CACHE,
                                 torch.float32)
        p_bytes = _tree_bytes(mesh, params, param_shardings(mesh, params))
        s_bytes = _tree_bytes(mesh, states, state_shardings(mesh, states))
        check(got["mesh"] == {"data": dp, "model": tp},
              f"serve_sharded {run_id}: mesh {got['mesh']}")
        check(np.array_equal(np.asarray(got["tokens"]), want),
              f"serve_sharded {run_id} {name}: tokens {got['tokens']} "
              f"against one rank's {want.tolist()}")
        check(got["rank_recompiles"] == [0, 0],
              f"serve_sharded {run_id}: recompiles by rank "
              f"{got['rank_recompiles']}")
        check(got["param_bytes"] == [p_bytes] * 2
              and got["state_bytes"] == [s_bytes] * 2,
              f"serve_sharded {run_id}: placed {got['param_bytes']} and "
              f"{got['state_bytes']}, the dry-run counts {p_bytes} and "
              f"{s_bytes}")
        check(got["launches"] == {"K1": 0, "K2": 0},
              f"serve_sharded {run_id}: rank 0 launched {got['launches']}")
        phase("serve_sharded", run=run_id, mesh=name, ranks=2,
              arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
              kv_heads=cfg.n_kv_heads, pim_scope="full",
              backend="gloo (both ranks on one card, every collective "
                      "through the host)",
              tokens_equal=True, sample=json.dumps(got["tokens"][0]),
              recompiles=json.dumps(got["rank_recompiles"]),
              param_bytes=json.dumps(got["param_bytes"]),
              state_bytes=json.dumps(got["state_bytes"]),
              spec_count=json.dumps([p_bytes, s_bytes]),
              peak_bytes=json.dumps(got["peak_bytes"]),
              one_rank_peak=peak,
              prefill_s_shared_card=round(got["prefill_s"], 4),
              decode_tok_s_shared_card=round(
                  SERVE_BATCH * got["tokens_per_s"], 3),
              token_p50_us=round(got["token_p50_us"], 1),
              token_p99_us=round(got["token_p99_us"], 1),
              card=json.dumps(smi))
        if spans:
            # Host seconds inside each gloo call on rank 0: the call
            # waits for the card's queue and for the other rank too.
            phase("serve_sharded", run=run_id, rank=0, span_s=json.dumps(
                {k: [n, round(t, 4)] for k, (n, t) in sorted(
                    spans.items(), key=lambda kv: -kv[1][1])
                 if k.startswith(("dist.", "serve."))}))
    obs.reset_trace()
    phase("serve_sharded", ranks_wall_s=round(wall, 1),
          seconds=round(time.perf_counter() - t_phase, 1))

def tp_families_phase(smi: str) -> None:
    """Phase 29: the launchers on (1, 2) over two ranks sharing the card
    (all runs in one launch of the ranks) for MoE, RWKV-6, RG-LRU and
    enc-dec, each against a one-rank run in this process (see the module
    docstring)."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import (_tree_bytes, abstract_states,
                                           train_state_bytes)
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.model import abstract_params
    from repro_torch.train.sharding import param_shardings, state_shardings
    t_phase = time.perf_counter()
    backend = ("gloo (both ranks on one card, every collective through "
               "the host)")
    runs, launches = [], []
    for run_id, kind, arch, layers, extra in TP_FAMILY_RUNS:
        cfg = get_config(arch)
        argv = ["--arch", arch] + extra
        if layers is not None:
            cfg = cfg.scaled(n_layers=layers)
            argv += ["--override", json.dumps({"n_layers": layers})]
        mesh = abstract_mesh((1, 2), ("data", "model"))
        params = abstract_params(cfg, torch.float32)
        name = f"tp_families {run_id} ({arch})"
        summary = BUILD / f"tp_families_{run_id}.json"
        trace = BUILD / f"tp_families_{run_id}_trace.json"
        if kind == "train":
            one, peak, one_s = one_rank_run(argv, cfg.n_layers)
            check(len(one.losses) == 3 and all(np.isfinite(one.losses)),
                  f"{name}: one-rank losses {one.losses}")
            one_fields = dict(losses=json.dumps(one.losses),
                              step_s=json.dumps(one.step_s),
                              wall_s=round(one_s, 1))
            want = {"losses": one.losses, "lrs": one.lrs,
                    "grad_norms": one.grad_norms}
            module = "repro_torch.launch.train"
            spec_count = [train_state_bytes(cfg, mesh, params)]
        else:
            one, peak = serve_one_rank(argv)
            check(one.recompiles == 0,
                  f"{name}: one rank recompiled {one.recompiles}")
            one_fields = dict(
                prefill_s=round(one.prefill_s, 4),
                decode_tok_s=round(SERVE_BATCH * one.tokens_per_s, 3),
                token_p50_us=round(one.latency_us(50), 1),
                token_p99_us=round(one.latency_us(99), 1))
            want = one.tokens
            module = "repro_torch.launch.serve"
            states = abstract_states(cfg, SERVE_BATCH, SERVE_SHARDED_CACHE,
                                     torch.float32)
            spec_count = [_tree_bytes(mesh, params,
                                      param_shardings(mesh, params)),
                          _tree_bytes(mesh, states,
                                      state_shardings(mesh, states))]
        del one
        phase("tp_families", run=run_id, mesh="1x1", launcher=kind,
              arch=cfg.name, layers=cfg.n_layers, peak_bytes=peak,
              **one_fields)
        traced = ["--trace", str(trace)] if run_id == "a" else []
        launches.append([module, argv + traced + [
            "--model-parallel", "2", "--dist-backend", "gloo",
            "--summary", str(summary)]])
        runs.append((run_id, kind, cfg, name, want, peak, spec_count,
                     summary, trace))
    wall = run_launches(2, launches)
    for (run_id, kind, cfg, name, want, peak, spec_count, summary,
         trace) in runs:
        got = json.loads(summary.read_text())
        summary.unlink()
        trace.unlink(missing_ok=True)
        check(got["mesh"] == {"data": 1, "model": 2},
              f"{name}: mesh {got['mesh']}")
        check(all(p < peak for p in got["peak_bytes"]),
              f"{name}: rank peaks {got['peak_bytes']} not below one "
              f"rank's {peak}")
        fields = {}
        if kind == "train":
            for key, rtol in (("losses", TRAIN_SHARDED_LOSS_RTOL),
                              ("lrs", TRAIN_SHARDED_LOSS_RTOL),
                              ("grad_norms", TRAIN_SHARDED_NORM_RTOL)):
                err = max(abs(a - b) / abs(b)
                          for a, b in zip(got[key], want[key]))
                check(len(got[key]) == len(want[key]) and err <= rtol,
                      f"{name}: {key} {got[key]} against one rank's "
                      f"{want[key]} (relative {err} > {rtol})")
                fields[key + "_rel_err"] = err
            check(got["placed_bytes"] == spec_count * 2,
                  f"{name}: placed {got['placed_bytes']}, the dry-run "
                  f"counts {spec_count}")
            fields.update(losses=json.dumps(got["losses"]),
                          placed_bytes=json.dumps(got["placed_bytes"]),
                          step_s_shared_card=json.dumps(got["step_s"]))
        else:
            check(np.array_equal(np.asarray(got["tokens"]), want),
                  f"{name}: tokens {got['tokens']} against one rank's "
                  f"{want.tolist()}")
            check(got["rank_recompiles"] == [0, 0],
                  f"{name}: recompiles by rank {got['rank_recompiles']}")
            check([got["param_bytes"], got["state_bytes"]]
                  == [[c] * 2 for c in spec_count],
                  f"{name}: placed {got['param_bytes']} and "
                  f"{got['state_bytes']}, the dry-run counts {spec_count}")
            check(got["launches"] == {"K1": 0, "K2": 0},
                  f"{name}: rank 0 launched {got['launches']}")
            fields.update(
                tokens_equal=True, sample=json.dumps(got["tokens"][0]),
                recompiles=json.dumps(got["rank_recompiles"]),
                param_bytes=json.dumps(got["param_bytes"]),
                state_bytes=json.dumps(got["state_bytes"]),
                prefill_s_shared_card=round(got["prefill_s"], 4),
                decode_tok_s_shared_card=round(
                    SERVE_BATCH * got["tokens_per_s"], 3),
                token_p50_us=round(got["token_p50_us"], 1),
                token_p99_us=round(got["token_p99_us"], 1))
        phase("tp_families", run=run_id, mesh="1x2", ranks=2,
              launcher=kind, arch=cfg.name, layers=cfg.n_layers,
              d_model=cfg.d_model, backend=backend, **fields,
              spec_count=json.dumps(spec_count),
              peak_bytes=json.dumps(got["peak_bytes"]),
              one_rank_peak=peak, card=json.dumps(smi))
    obs.reset_trace()
    phase("tp_families", ranks_wall_s=round(wall, 1),
          seconds=round(time.perf_counter() - t_phase, 1))

def fault_rank(out_dir: str, kill: bool) -> None:
    """One rank of phase 30 (``--fault-rank OUT [--kill]``): its runs
    (see ``FAULT_*``) on the card, in one gloo process group of the
    world's ranks (the environment's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``, or ``python -m
    torch.distributed.run`` without ``--kill``: its agent ends every
    rank when one dies). Rank 0 writes ``rank0.json`` into ``out_dir``:
    the unfailed losses, each run's steps and losses, restarts, recovery
    seconds, whether the final parameters are equal, the lost ranks and
    the losses after the re-mesh; the killed rank writes the wall time
    of its kill into ``killed``."""
    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root / "src"), str(root / "tests")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import _torch_sharded_cases as cases   # the CPU tests' injector, runner
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.model import abstract_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, restore_checkpoint
    from repro_torch.train.fault import RanksLost, elastic_remesh
    from repro_torch.train.sharding import train_state_specs
    from repro_torch.tree import tree_leaves
    dist.init_distributed("gloo")
    try:
        rank, world = dist.rank(), dist.world_size()
        last = world - 1
        dev = dist.local_device("cuda")
        torch.cuda.set_device(dev)
        cfg = get_config("qwen3-8b").scaled(n_layers=FAULT_LAYERS)
        model = build_model(cfg, remat=True, engine=Engine())
        opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=50)
        raw = make_batch_fn(DataConfig(vocab_size=cfg.vocab_size,
                                       **FAULT_DATA))

        def batch_at(s):
            return {k: torch.from_numpy(v).to(dev)
                    for k, v in raw(s).items()}
        mesh = make_host_mesh(world)
        _, init_fn, jit_for = make_train_step(model, opt, mesh)
        state = init_fn(0)
        jit = jit_for(state[0], batch_at(0))
        whole = []
        for s in range(FAULT_STEPS):            # unfailed, no fence
            *state, met = jit(*state, batch_at(s))
            whole.append(float(met["loss"]))
            if s == FAULT_STEP:
                keep = [x.detach().clone() for x in tree_leaves(state[0])]
        del state, met
        ckpt_dir = os.path.join(out_dir, "ckpt")
        seen, taken = [], {"step": -1}
        real = dist.all_reduce
        if rank == last:
            dist.all_reduce, _ = cases._fault_in(
                "backward", lambda: taken["step"], FAULT_STEP)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, metrics = cases._runner(
            cfg, mesh, jit, ckpt_dir, batch_at, seen, taken).run(
                init_fn(0), 0, FAULT_STEP + 1)
        dist.all_reduce = real
        out = {"whole": whole, "seen": seen, "restarts": metrics["restarts"],
               "recovery_s": metrics["recovery_s"],
               "wall_s": time.perf_counter() - t0,
               "params_equal": all(torch.equal(a, b) for a, b in zip(
                   tree_leaves(state[0]), keep)),
               "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        del keep
        if kill:
            taken["step"] = -1

            def stamp():
                with open(os.path.join(out_dir, "killed"), "w") as f:
                    f.write(repr(time.time()))
            if rank == last:
                dist.all_reduce, _ = cases._fault_in(
                    "kill", lambda: taken["step"], FAULT_STEP + 1,
                    before_kill=stamp)
            try:
                cases._runner(cfg, mesh, jit, ckpt_dir, batch_at, [],
                              taken).run(state, FAULT_STEP + 1, 1)
            except RanksLost as e:
                out.update(lost=list(e.ranks), error=str(e),
                           noticed=time.time())
            del state
            torch.cuda.empty_cache()
            check("lost" in out, f"the run went on without rank {last}")
            survivors = elastic_remesh(list(range(last)),
                                       model_parallel=world)
            step2, init2, _ = make_train_step(model, opt, survivors)
            params, opt_state, res = init2(0)
            ps, os_, _ = train_state_specs(survivors, abstract_params(cfg))
            t0 = time.perf_counter()
            back, at = restore_checkpoint(
                ckpt_dir, {"params": params, "opt": opt_state},
                mesh=survivors, specs={"params": ps, "opt": os_})
            out["restore_s"] = time.perf_counter() - t0
            params, opt_state = back["params"], back["opt"]
            after = []
            for s in range(at, FAULT_STEPS):
                params, opt_state, res, met = step2(params, opt_state, res,
                                                    batch_at(s))
                after.append([s, float(met["loss"])])
            out.update(mesh=survivors.shape, restored=at, after=after)
        if rank == 0:
            with open(os.path.join(out_dir, "rank0.json"), "w") as f:
                json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def fault_sharded_phase(smi: str) -> None:
    """Phase 30: a fault inside a sharded step, two processes of
    :func:`fault_rank` sharing the card (see ``FAULT_*``)."""
    import signal
    import socket
    from repro_torch import dist
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=BUILD) as out_dir:
        procs = [subprocess.Popen(
            [sys.executable, str(root / "chip_smoke.py"), "--fault-rank",
             out_dir, "--kill"], cwd=str(root),
            env=dict(os.environ, OMP_NUM_THREADS="4", RANK=str(r),
                     LOCAL_RANK=str(r), WORLD_SIZE="2",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=RANKS_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.communicate()
        for r, (p, (o, e)) in enumerate(zip(procs, outs)):
            want = -signal.SIGKILL if r == 1 else 0
            check(p.returncode == want, f"fault_sharded: rank {r} exited "
                  f"{p.returncode}:\n{o[-2000:]}\n{e[-4000:]}")
        got = json.loads((Path(out_dir) / "rank0.json").read_text())
        killed_at = float((Path(out_dir) / "killed").read_text())
        wall = time.perf_counter() - t_phase
    whole, at = got["whole"], FAULT_STEP
    # the failed step's loss is not kept; step 2 (done) and 3 replayed
    want_seen = list(range(at)) + [at - 1, at]
    check(got["restarts"] == 1 and [s for s, _ in got["seen"]] == want_seen,
          f"fault_sharded raise: restarts {got['restarts']}, steps "
          f"{got['seen']}")
    check(all(loss == whole[s] for s, loss in got["seen"]),
          f"fault_sharded raise: losses {got['seen']} against the "
          f"unfailed {whole}")
    check(got["params_equal"], "fault_sharded raise: the final parameters "
                               "differ from the unfailed run's")
    phase("fault_sharded", run="raise", arch="qwen3-8b",
          layers=FAULT_LAYERS, mesh="1x2", ranks=2, fault_step=at,
          where="backward", restarts=got["restarts"],
          steps=json.dumps(want_seen),
          losses=json.dumps(whole[:at + 1]), replayed_equal=True,
          params_equal=True, recovery_s=json.dumps(got["recovery_s"]),
          group_timeout_s=dist.DEFAULT_TIMEOUT_S,
          runner_wall_s=round(got["wall_s"], 1),
          peak_bytes=got["peak_bytes"], card=json.dumps(smi))
    noticed = got["noticed"] - killed_at
    check(got["lost"] == [1] and "[1]" in got["error"],
          f"fault_sharded kill: rank 0 raised {got['error']}")
    check(noticed < dist.DEFAULT_TIMEOUT_S / 10,
          f"fault_sharded kill: rank 0 noticed after {noticed} s")
    check(got["mesh"] == {"data": 1, "model": 1}
          and got["restored"] == at + 1,
          f"fault_sharded kill: re-meshed {got['mesh']} from step "
          f"{got['restored']}")
    err = max(abs(loss - whole[s]) / abs(whole[s]) for s, loss in
              got["after"])
    check([s for s, _ in got["after"]] == [at + 1]
          and err <= TRAIN_SHARDED_LOSS_RTOL,
          f"fault_sharded kill: {got['after']} against the unfailed "
          f"{whole} ({err})")
    phase("fault_sharded", run="kill", killed_step=at + 1,
          where="forward", lost=got["lost"], noticed_s=round(noticed, 2),
          group_timeout_s=dist.DEFAULT_TIMEOUT_S, remesh="1x1",
          restored_step=got["restored"],
          restore_s_one_rank=round(got["restore_s"], 1),
          losses_after=json.dumps(got["after"]), rel_err=err,
          wall_s=round(wall, 1),
          seconds=round(time.perf_counter() - t_phase, 1))


def heads_argv(extra: list) -> list:
    """A launcher's arguments for phase 31's whisper-small (cut)."""
    return (["--arch", "whisper-small", "--override",
             json.dumps(TP_HEADS_WHOLE_CUT)] + extra)


def launches_rank(spec: str) -> None:
    """One rank of a launch (``--launches``, under ``python -m
    torch.distributed.run``) that runs each ``[module, argv]`` of the
    JSON list ``spec`` in turn, ``module.main(argv)``, in one gloo
    process group: the ranks' processes start once for all of a phase's
    runs. Before each run the memory is freed and the peak statistics
    and the kernels' launch counts set to 0; after it tracing stops."""
    import importlib
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import dist, obs
    from repro_torch.kernels.bitserial_matmul import bitserial_matmul
    from repro_torch.kernels.crossbar_step import (crossbar_run,
                                                   crossbar_run_packed)
    dist.init_distributed("gloo")
    try:
        for module, argv in json.loads(spec):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            crossbar_run_packed.launches = crossbar_run.launches = 0
            bitserial_matmul.launches = 0
            importlib.import_module(module).main(argv)
            obs.disable()
            obs.reset_trace()
    finally:
        torch.distributed.destroy_process_group()


def run_launches(nproc: int, launches: list,
                 timeout: float = RANKS_TIMEOUT_S) -> float:
    """:func:`launches_rank`'s list ``launches`` on ``nproc`` ranks
    sharing the card: :func:`run_ranks` of this script's rank entry.
    Returns the wall seconds."""
    return run_ranks(nproc, "chip_smoke",
                     ["--launches", json.dumps(launches)], timeout)

def tp_heads_whole_phase(smi: str) -> None:
    """Phase 31: whisper-small on (1, 8), its heads whole on every rank
    (see ``TP_HEADS_WHOLE_*``), each launcher against one rank in this
    process."""
    from repro_torch.configs import get_config
    from repro_torch.dist import ParallelAxis
    from repro_torch.models.blocks import heads_split
    t_phase = time.perf_counter()
    n = TP_HEADS_WHOLE_RANKS
    cfg = get_config("whisper-small").scaled(**TP_HEADS_WHOLE_CUT)
    check(not heads_split(cfg, ParallelAxis(None, n, 0)),
          f"tp_heads_whole: {cfg.n_heads} heads split over {n}")
    one_serve, serve_peak = serve_one_rank(
        heads_argv(TP_HEADS_WHOLE_RUNS[0][1]))
    one_train, train_peak, _ = one_rank_run(
        heads_argv(TP_HEADS_WHOLE_RUNS[1][1]), cfg.n_layers)
    with tempfile.TemporaryDirectory(dir=BUILD) as out_dir:
        wall = run_launches(n, [
            [f"repro_torch.launch.{kind}", heads_argv(extra) + [
                "--model-parallel", str(n), "--dist-backend", "gloo",
                "--summary", os.path.join(out_dir, f"{kind}.json")]]
            for kind, extra in TP_HEADS_WHOLE_RUNS])
        got = {kind: json.loads((Path(out_dir) / f"{kind}.json")
                                .read_text())
               for kind, _ in TP_HEADS_WHOLE_RUNS}
    for kind, one, peak in (("serve", one_serve, serve_peak),
                            ("train", one_train, train_peak)):
        run, name = got[kind], f"tp_heads_whole {kind}"
        check(run["mesh"] == {"data": 1, "model": n},
              f"{name}: mesh {run['mesh']}")
        fields = {}
        if kind == "train":
            for key, rtol in (("losses", TRAIN_SHARDED_LOSS_RTOL),
                              ("lrs", TRAIN_SHARDED_LOSS_RTOL),
                              ("grad_norms", TRAIN_SHARDED_NORM_RTOL)):
                want = getattr(one, key)
                err = max(abs(a - b) / abs(b)
                          for a, b in zip(run[key], want))
                check(len(run[key]) == len(want) and err <= rtol,
                      f"{name}: {key} {run[key]} against one rank's "
                      f"{want} (relative {err} > {rtol})")
                fields[key + "_rel_err"] = err
            fields.update(losses=json.dumps(run["losses"]),
                          step_s_shared_card=json.dumps(run["step_s"]))
        else:
            check(np.array_equal(np.asarray(run["tokens"]), one.tokens),
                  f"{name}: tokens {run['tokens']} against one rank's "
                  f"{one.tokens.tolist()}")
            check(run["rank_recompiles"] == [0] * n,
                  f"{name}: recompiles by rank {run['rank_recompiles']}")
            fields.update(tokens_equal=True,
                          sample=json.dumps(run["tokens"][0]),
                          decode_tok_s_shared_card=round(
                              SERVE_BATCH * run["tokens_per_s"], 3))
        phase("tp_heads_whole", launcher=kind, arch="whisper-small",
              layers=cfg.n_layers, enc_layers=cfg.enc_layers,
              heads=cfg.n_heads, mesh=f"1x{n}", ranks=n,
              backend="gloo (all ranks on one card, every collective "
                      "through the host)", **fields,
              peak_bytes=json.dumps(run["peak_bytes"]), one_rank_peak=peak,
              card=json.dumps(smi))
    phase("tp_heads_whole", ranks_wall_s=round(wall, 1),
          seconds=round(time.perf_counter() - t_phase, 1))


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
    """Run every phase on card 0 with the program cache's disk spill in
    an empty directory under ``build/``; raise on the first failure."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    BUILD.mkdir(exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="program-cache-", dir=BUILD)
    os.environ["REPRO_CACHE_DIR"] = cache_dir
    try:
        run_phases()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run_phases() -> None:
    """The phases of the module docstring, in order."""
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

    # ------------------------------------ 14-16. the device-trace slice ----
    area = area_phase(rng, dev, sm_clock_hz)
    k1_err = max(k1_err, area["k1_err"])
    k2_err = max(k2_err, area["k2_err"])
    main_launches["K1"] += area["launches"]["K1"]
    torch.cuda.empty_cache()
    replayed = trace_replay_phase(dev)
    k1_err = max(k1_err, replayed["errs"]["K1"])
    k2_err = max(k2_err, replayed["errs"]["K2"])
    main_launches["K1"] += replayed["launches"]["K1"]
    main_launches["K2"] += replayed["launches"]["K2"]
    block_trace_phase()
    disk_cache_phase(rng, dev)
    torch.cuda.empty_cache()

    # -------------------------------------------- 17-19. the model slice ----
    model_parity_phase(dev)
    model_consistency_phase(dev)
    serve_tokens, serve_peak = model_serve_phase(dev)

    # -------------------------------------------- 20-23. the training slice ----
    train_parity_phase(dev)
    train_overfit_phase(dev)
    train_resume_phase(dev)
    train_phase(dev)

    # ---------------------------------------------- 24-25. the dry-run ----
    with tempfile.TemporaryDirectory(dir=BUILD) as rank_out:
        ranks = start_dryrun_ranks(rank_out)
        try:
            dryrun_phase()
            dryrun_check_phase(smi, ranks, rank_out)
        finally:
            if ranks[0].poll() is None:        # a phase failed: stop them
                import signal
                os.killpg(ranks[0].pid, signal.SIGKILL)
                ranks[0].communicate()

    # ------------------------------------- 26-27. sharded training ----
    probe = gloo_cuda_phase()
    train_sharded_phase(smi)
    elastic_card_phase()

    # ---------------------------------------- 28. sharded serving ----
    serve_sharded_phase(smi, probe, serve_tokens, serve_peak)

    # ------------------------------- 29. tensor-parallel families ----
    tp_families_phase(smi)

    # ------------------------- 30-31. faults and heads on a mesh ----
    fault_sharded_phase(smi)
    tp_heads_whole_phase(smi)
    check(all(main_launches[k] > 0 for k in ("K1", "K2", "K3")),
          f"a kernel of the main path never launched: {main_launches}")

    # ------------------------------------------------- 30. kernels line ----
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
                  f"{k1_main['shape'][1]} columns",
         "multpim_area": area["k1"]},
        {"name": "K2 crossbar_run (unpacked)",
         "route": "cuda", "source": SOURCE, "replaces": K2_REPLACES,
         "launches": main_launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None, "library_note": NO_LIBRARY,
         "shape": f"multpim N={N_BITS}, {ROWS} rows x {c} columns",
         "multpim_area": area["k2"]},
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
    if sys.argv[1:2] == ["--dryrun-rank"]:
        dryrun_rank(json.loads(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--launches"]:
        launches_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--fault-rank"]:
        fault_rank(sys.argv[2], kill="--kill" in sys.argv[3:])
    else:
        main()
