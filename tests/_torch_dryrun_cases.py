"""Process-side code of ``tests/test_torch_dryrun_sharded.py`` (imports
no JAX: a spawned process imports this module).

:func:`records` makes the dry-run's records of the cases in a process of
its own (each in a fake world of its mesh's ranks); :func:`rank_cases`
runs the same cases as real steps on one rank of a gloo group of four,
each (1, 2) case on ranks 0-1 and on ranks 2-3 at once, each (2, 2) and
(1, 4) case on all four. :func:`first_and_last`,
:func:`extrapolations` and :func:`production` trace in fake worlds of
their own, each in a process of its own.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.configs import SHAPES as FULL_SHAPES
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (abstract_mesh, make_production_mesh,
                                     mesh_over_ranks)
from repro_torch.models.transformer import stack_plan

NAMES = ("data", "model")
SHAPES = {"train": ShapeSpec("train_s", 32, 4, "train"),
          "prefill": ShapeSpec("prefill_s", 48, 2, "prefill"),
          "decode": ShapeSpec("decode_s", 40, 4, "decode")}
# a warm-up and eight measured steps: on the host real_step takes the
# least live bytes of the measured steps (see its docstring)
STEPS = 9
COUNTS = ("flops", "bytes_accessed", "collective_bytes")
# (arch, kind, (data, model), microbatches, config overrides)
CASES = [
    ("qwen3-8b", "train", (1, 2), 2, {}),
    ("qwen3-8b", "train", (2, 2), 2, {}),
    ("gemma2-9b", "decode", (1, 2), 1, {}),
    ("granite-20b", "decode", (1, 2), 1, {}),
    ("deepseek-moe-16b", "decode", (1, 2), 1, {}),
    ("deepseek-moe-16b", "train", (1, 2), 2, {}),
    ("rwkv6-7b", "decode", (1, 2), 1, {}),
    ("recurrentgemma-9b", "prefill", (1, 2), 1, {}),
    ("whisper-small", "prefill", (1, 2), 1, {}),
    # two KV heads over four model ranks: the cache splits over the
    # sequence and each rank computes one KV head of two
    ("gemma2-9b", "decode", (1, 4), 1, {"n_kv_heads": 2}),
]
# the ranks of each mesh shape's meshes, in the order they are made
PLACEMENT = {(1, 2): [[0, 1], [2, 3]], (2, 2): [[0, 1, 2, 3]],
             (1, 4): [[0, 1, 2, 3]]}


def case_id(case) -> str:
    arch, kind, mesh, mb, over = case
    extra = "".join(f"-{k}{v}" for k, v in over.items())
    return f"{arch}-{kind}-{mesh[0]}x{mesh[1]}-mb{mb}{extra}"


def config(arch: str, over: dict):
    cfg = get_config(arch, smoke=True)
    return cfg.scaled(**over) if over else cfg


def records(cases) -> list:
    """``cell_record`` of each case (rank 0's, traced in a fake world)."""
    return [dryrun.cell_record(config(arch, over), SHAPES[kind],
                               abstract_mesh(mesh, NAMES),
                               microbatches=mb)
            for arch, kind, mesh, mb, over in cases]


def partial_heads_case(mesh) -> dict:
    """Prefill and greedy decode of the (1, 4) case's config on ``mesh``
    against one process from the same parameters and prompts
    (``_torch_serve_cases.greedy``): the tokens equal, the worst logit
    error relative to one rank's largest logit and the worst cache
    error relative to each leaf's largest value."""
    from _torch_serve_cases import _max_rel, greedy, inputs

    from repro_torch.engine import Engine
    from repro_torch.models import build_model
    from repro_torch.train.sharding import param_shardings, shard_tree
    cfg = config("gemma2-9b", {"n_kv_heads": 2})
    model = build_model(cfg, engine=Engine("torch:device=cpu"))
    whole = model.init(0)
    prompts = torch.from_numpy(inputs(cfg, 4)[0])
    want, want_seen, _ = greedy(model, whole, prompts, None)
    params = shard_tree(mesh, whole, param_shardings(mesh, whole))
    got, got_seen, _ = greedy(model, params, prompts, None, mesh)
    logits = caches = 0.0
    for (gl, gs), (wl, ws) in zip(got_seen, want_seen):
        logits = max(logits, _max_rel(gl, wl))
        caches = max(caches, max(_max_rel(a, b) for a, b in zip(gs, ws)))
    return {"tokens_equal": bool(torch.equal(got, want)), "logits": logits,
            "caches": caches}


def rank_cases(rank: int, cases) -> list:
    """This rank's ``real_step(mesh=...)`` of each case on the CPU (for a
    decode case also the same steps in one process without a mesh,
    ``one``: the tokens to hold the sharded steps' against), then
    :func:`partial_heads_case` on (1, 4)."""
    torch.manual_seed(0)
    meshes = {}
    for shape, groups in PLACEMENT.items():
        for ranks in groups:
            mesh = mesh_over_ranks(shape, NAMES, ranks)
            if mesh.comm is not None:
                meshes[shape] = mesh
    out = []
    for arch, kind, shape, mb, over in cases:
        cfg = config(arch, over)
        real = dryrun.real_step(cfg, SHAPES[kind], microbatches=mb,
                                steps=STEPS, mesh=meshes[shape],
                                device="cpu")
        if kind == "decode":
            real["one"] = dryrun.real_step(cfg, SHAPES[kind], steps=STEPS,
                                           device="cpu")["outputs"]
        out.append(real)
    out.append(partial_heads_case(meshes[(1, 4)]))
    try:
        with dist.fake_world((2, 2)):
            refused = None
    except RuntimeError as e:       # a gloo group is running here
        refused = str(e)
    out.append(refused)
    return out


def deep_smoke(arch: str, units: int = 5):
    """``arch``'s smoke config with ``units`` stacked units."""
    cfg = get_config(arch, smoke=True)
    prefix, unit, _, suffix = stack_plan(cfg.scaled(
        n_layers=cfg.n_layers * 4))
    return cfg.scaled(n_layers=len(prefix) + units * len(unit)
                      + len(suffix))


# test_torch_dryrun.py's extrapolation cases: (arch, kind, microbatches)
EXTRAPOLATION_CASES = [
    ("qwen3-8b", "train", 1), ("gemma2-9b", "train", 2),
    ("deepseek-moe-16b", "train", 1), ("whisper-small", "train", 2),
    ("recurrentgemma-9b", "prefill", 1), ("rwkv6-7b", "prefill", 1),
    ("pixtral-12b", "prefill", 1), ("qwen3-8b", "flash", 1)]


def extrapolations(cases) -> list:
    """For each case, rank 0 of (1, 2) traced at full depth (5 units) and
    its counts extrapolated from 2 and 3 units (train's bytes accessed
    through 2, 3 and 4): ``(full, extrapolated, full step's end,
    extrapolated step's end, full temp, extrapolated temp)``."""
    out = []
    with dist.fake_world((1, 2)):
        mesh = mesh_over_ranks((1, 2), NAMES)
        for arch, kind, mb in cases:
            cfg = deep_smoke(arch)
            shape = (ShapeSpec("flash_s", 2560, 1, "prefill")
                     if kind == "flash" else SHAPES[kind])
            rows = shape.global_batch // (mb if kind == "train" else 1)
            full, two, three = (dryrun.trace_step(
                cfg, shape, rows, units=u, microbatches=mb, mesh=mesh)
                for u in (None, 2, 3))
            four = (dryrun.trace_step(cfg, shape, rows, units=4,
                                      microbatches=mb, mesh=mesh)
                    if kind == "train" else None)
            temp = max(dryrun._extrapolate(a - two["args_bytes"],
                                           b - three["args_bytes"], 5)
                       for a, b in zip(two["peaks"], three["peaks"]))
            out.append(({k: full[k] for k in COUNTS},
                        dryrun._counts_at(two, three, 5, four),
                        full["step"],
                        dryrun._counts_at(two["step"], three["step"], 5,
                                          four and four["step"]),
                        full["peak_bytes"] - full["args_bytes"], temp))
    return out


# a rank's counts on 16 x 16, at full width cut to two units
EDGE_CELLS = [("qwen3-8b", "decode_32k"), ("qwen3-8b", "train_32")]
TRAIN_32 = ShapeSpec("train_32", 32, 256, "train")


def _shape(name: str):
    if name == TRAIN_32.name:
        return TRAIN_32
    if name == PREFILL_256.name:
        return PREFILL_256
    return next(s for s in FULL_SHAPES if s.name == name)


def first_and_last(cells) -> list:
    """For each (arch, shape) cell at full width cut to two units: rank
    0's and rank 255's traces on 16 x 16 (one microbatch of 2 rows a
    rank for train), as ``(first, last)`` dicts of ``flops``,
    ``bytes_accessed``, ``collective_bytes`` and ``temp``."""
    out = []
    for arch, name in cells:
        cfg = dryrun.at_depth(get_config(arch), 2)
        shape = _shape(name)
        rows = 2 if shape.kind == "train" else shape.global_batch
        pair = []
        for rank in (0, 255):
            with dist.fake_world((16, 16), rank=rank):
                mesh = mesh_over_ranks((16, 16), NAMES)
                assert mesh.comm.rank == rank
                tr = dryrun.trace_step(cfg, shape, rows, microbatches=8,
                                       mesh=mesh)
            pair.append({**{k: tr[k] for k in COUNTS},
                         "temp": tr["peak_bytes"] - tr["args_bytes"]})
        out.append(tuple(pair))
    return out


# The production records: every arch at full width cut to two units, on
# both production meshes, at decode_32k and a train shape of the
# production batch over 32 tokens (whisper-small also at a prefill of 32
# x 256), in three groups that trace in parallel.
PREFILL_256 = ShapeSpec("prefill_256", 256, 32, "prefill")
PRODUCTION_GROUPS = [
    ["rwkv6-7b", "deepseek-7b", "granite-20b", "whisper-small"],
    ["recurrentgemma-9b", "deepseek-moe-16b"],
    ["gemma2-9b", "phi3.5-moe-42b-a6.6b", "pixtral-12b", "qwen3-8b"]]


def production(archs) -> dict:
    """``{(arch, shape, mesh): record}`` of each arch in ``archs``."""
    out = {}
    for arch in archs:
        cfg = dryrun.at_depth(get_config(arch), 2)
        shapes = [_shape("decode_32k"), TRAIN_32]
        if arch == "whisper-small":
            shapes.append(PREFILL_256)
        mb = dryrun.MICROBATCHES_BY_ARCH.get(
            (arch, "train_4k"), dryrun.MICROBATCHES["train_4k"])
        for shape in shapes:
            for multi_pod in (False, True):
                rec = dryrun.cell_record(
                    cfg, shape, make_production_mesh(multi_pod=multi_pod),
                    microbatches=mb if shape.kind == "train" else 1)
                out[(arch, shape.name, rec["mesh"])] = rec
    return out
