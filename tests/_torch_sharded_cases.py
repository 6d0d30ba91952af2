"""What each rank runs in ``tests/test_torch_sharded.py`` (no JAX here:
a spawned rank imports this module).

:func:`step_cases` holds the sharded train step against the unsharded
one on every rank, both from the reference's initial parameters (a
pickled numpy tree, through ``convert.params_from_numpy``): placed leaf
shapes, the forward's logits, the loss and gradients of one batch, then
``steps`` AdamW steps (loss, grad_norm, lr each step; parameters, ``m``,
``v`` and the residual, gathered, after the last). It returns the worst
errors, which the test holds to its tolerances, and for the cases the
test also holds against the reference's sharded step, the sharded run's
metrics and gathered parameters.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from repro_torch import dist
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.engine import Engine
from repro_torch.launch.mesh import mesh_over_ranks
from repro_torch.models import build_model
from repro_torch.models.model import abstract_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from repro_torch.train.sharding import (gather_leaf, shard_leaf,
                                        shard_shape, spec_leaves,
                                        train_state_specs)
from repro_torch.tree import tree_flatten, tree_leaves

AXES = ("data", "model")
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=60)


SCALED = {"whisper-small-h2": ("whisper-small", dict(n_heads=2,
                                                     n_kv_heads=2,
                                                     head_dim=32)),
          "rwkv6-7b-hd32": ("rwkv6-7b", dict(rwkv_head_dim=32)),
          "qwen3-8b-6x2": ("qwen3-8b", dict(n_heads=6, n_kv_heads=2)),
          "granite-20b-6x1": ("granite-20b", dict(n_heads=6))}


def smoke_config(name: str):
    """The smoke config of an architecture, or of one of ``SCALED``'s
    variants (an architecture's smoke config with fields changed)."""
    arch, changes = SCALED.get(name, (name, {}))
    cfg = get_config(arch, smoke=True)
    return cfg.scaled(**changes) if changes else cfg


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float64 (the leaf's norm as the measure)."""
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def stream(cfg, seq: int = 16, batch: int = 8, uneven: bool = False):
    """The deterministic batches of ``cfg`` (as torch tensors). With
    ``uneven`` the first half of the rows loses most of its labels (-1),
    so data ranks mask different numbers of tokens."""
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = (cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        extra["frames"] = (cfg.enc_frames, cfg.d_model)
    fn = make_batch_fn(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch), extra)

    def batch_at(step):
        b = {k: torch.from_numpy(v) for k, v in fn(step).items()}
        if uneven:
            b["labels"] = b["labels"].clone()
            b["labels"][: batch // 2, 3:] = -1
            b["labels"][batch // 2, :2] = -1
        return b
    return batch_at


def _unsharded_grads(model, params, batch):
    leaves = tree_leaves(params)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.detach() for g in grads]


def _sharded_grads(model, mesh, params, batch, plan_specs):
    """The loss and the gathered whole gradients of one batch on the
    mesh: each data rank's rows, summed over the data axis."""
    dp = mesh.comm.axis(("data",))
    rows = batch["tokens"].shape[0] // dp.size
    mine = {k: v[dp.index * rows:(dp.index + 1) * rows]
            for k, v in batch.items()}
    leaves = tree_leaves(params)
    loss = model.loss(params, mine, mesh)
    grads = torch.autograd.grad(loss, leaves)
    loss = dist.all_reduce(loss.detach().clone(), dp.group)
    out = []
    for g, spec in zip(grads, plan_specs):
        g = dist.all_reduce(g.detach().clone(), dp.group)
        out.append(gather_leaf(mesh, g, spec))
    return float(loss), out


def reference_init(init_dir: str, arch: str) -> list:
    """The leaves (JAX's order) of the reference's ``init_fn(PRNGKey(0))``
    for ``arch``, pickled as a numpy tree in ``init_dir``, as the port's
    tensors."""
    with open(os.path.join(init_dir, f"{arch}.pkl"), "rb") as f:
        return tree_leaves(params_from_numpy(pickle.load(f)))


@torch.no_grad()
def _start_from(mesh, whole: list, params, specs=None) -> None:
    """Write the whole leaves ``whole`` (or, with ``specs``, this rank's
    shards of them) into ``params``."""
    leaves = tree_leaves(params)
    if len(leaves) != len(whole):
        raise ValueError(f"{len(whole)} leaves for {len(leaves)}")
    for k, (x, w) in enumerate(zip(leaves, whole)):
        x.copy_(w if specs is None else shard_leaf(mesh, w, specs[k]))


def step_cases(rank: int, cases, init_dir: str, keep=(), steps: int = 3):
    """Run each case ``(arch, (dp, tp), microbatches, compress, remat,
    uneven)`` from the reference's parameters in ``init_dir``; returns,
    for each, None on a rank outside its mesh, else a dict of the worst
    relative errors and the shape check. For a case in ``keep`` the
    mesh's first rank adds the sharded run's ``trace`` (loss,
    grad_norm, lr each step) and its gathered ``final`` parameters."""
    cpu = Engine("torch:device=cpu")
    out = []
    for case in cases:
        arch, shape, microbatches, compress, remat, uneven = case
        mesh = mesh_over_ranks(shape, AXES, list(range(shape[0] * shape[1])))
        if mesh.comm is None:
            out.append(None)
            continue
        cfg = smoke_config(arch)
        model = build_model(cfg, remat=remat, engine=cpu)
        opt = AdamWConfig(**OPT)
        base, base_init, _ = make_train_step(
            model, opt, microbatches=microbatches, compress_grads=compress)
        step, init_fn, _ = make_train_step(
            model, opt, mesh, microbatches=microbatches,
            compress_grads=compress)
        ref = list(base_init(0))
        got = list(init_fn(0))
        whole = abstract_params(cfg, torch.float32)
        ps, os_, rs = train_state_specs(mesh, whole)
        pspecs = spec_leaves(ps, len(tree_leaves(whole)))
        zspecs = spec_leaves(rs, len(pspecs))
        start = reference_init(init_dir, arch)
        _start_from(mesh, start, ref[0])
        _start_from(mesh, start, got[0], pspecs)
        del start
        shapes_ok = all(
            tuple(x.shape) == shard_shape(mesh, tuple(w.shape), s)
            for x, w, s in zip(tree_leaves(got[0]), tree_leaves(whole),
                               pspecs))
        shapes_ok &= all(
            tuple(x.shape) == shard_shape(mesh, tuple(w.shape), s)
            for tree in (got[1].m, got[1].v) + ((got[2],) if compress
                                                 else ())
            for x, w, s in zip(tree_leaves(tree), tree_leaves(whole),
                               zspecs))
        batch_at = stream(cfg, uneven=uneven)
        res = {"shapes_ok": bool(shapes_ok), "logits": 0.0, "grad": 0.0,
               "loss": 0.0, "grad_norm": 0.0, "lr": 0.0}

        b0 = batch_at(0)
        if cfg.family == "decoder":
            want, _ = model.forward(ref[0], b0["tokens"])
            logits, _ = model.forward(got[0], b0["tokens"], mesh=mesh)
            tp = mesh.comm.axis(("model",))
            if logits.shape[-1] != want.shape[-1]:
                logits = dist.all_gather(logits, tp.group, dim=-1)
            res["logits"] = rel(logits, want)
        wl, wg = _unsharded_grads(model, ref[0], b0)
        gl, gg = _sharded_grads(model, mesh, got[0], b0, pspecs)
        res["loss"] = abs(gl - wl) / abs(wl)
        res["grad"] = max(rel(a, b) for a, b in zip(gg, wg))

        trace = []
        for s in range(steps):
            b = batch_at(s)
            *ref, rm = base(*ref, b)
            *got, gm = step(*got, b)
            trace.append({k: float(gm[k]) for k in ("loss", "grad_norm",
                                                    "lr")})
            for k in ("loss", "grad_norm", "lr"):
                w = float(rm[k])
                res[k] = max(res[k], abs(float(gm[k]) - w) / abs(w))
        pairs = {"params": (got[0], ref[0], pspecs),
                 "m": (got[1].m, ref[1].m, zspecs),
                 "v": (got[1].v, ref[1].v, zspecs)}
        if compress:
            pairs["residual"] = (got[2], ref[2], zspecs)
        for name, (g_tree, r_tree, specs) in pairs.items():
            res[name], off, total = 0.0, 0, 0
            for x, y, s in zip(tree_leaves(g_tree), tree_leaves(r_tree),
                               specs):
                x = gather_leaf(mesh, x, s)
                res[name] = max(res[name], rel(x, y))
                diff = (x.detach() - y.detach()).abs()
                # an element off: beyond float noise of the leaf; for the
                # residual (within half a quantum of 0), half a quantum
                cut = 0.5 if name == "residual" else 1e-5
                off += int((diff > cut * y.detach().abs().max()).sum())
                total += y.numel()
            res[name + "_off"] = off / total
        res["count"] = int(got[1].count)
        if tuple(case) in keep:
            final = [gather_leaf(mesh, x, sp).numpy().copy()
                     for x, sp in zip(tree_leaves(got[0]), pspecs)]
            if not any(mesh.comm.coords):
                res["trace"], res["final"] = trace, final
        out.append(res)
    return out


def psum_case(rank: int, stacked: np.ndarray):
    """``compressed_psum`` of row ``rank`` of ``stacked`` over the world,
    and over ranks {0, 1} (a group of two)."""
    import torch.distributed as tdist
    from repro_torch.optim import compressed_psum
    pair = tdist.new_group([0, 1])
    g = torch.from_numpy(stacked[rank])
    world = compressed_psum(g).numpy()
    two = (compressed_psum(torch.from_numpy(stacked[rank % 2 + 0]), pair
                           ).numpy() if rank < 2 else None)
    return world, two


def compress_case(rank: int):
    """Error feedback on ZeRO-1 shards over (2, 2) against the whole
    leaves: the applied gradients and residuals, gathered, and the
    unsharded ones (every rank draws the same whole leaves)."""
    from repro_torch.optim import ef_compress_tree
    mesh = mesh_over_ranks((2, 2), AXES)
    cfg = get_config("qwen3-8b", smoke=True)
    whole = abstract_params(cfg, torch.float32)
    _, _, zs = train_state_specs(mesh, whole)
    specs = spec_leaves(zs, len(tree_leaves(whole)))
    gen = torch.Generator().manual_seed(5)
    grads = [torch.randn(w.shape, generator=gen) * 1e-2
             for w in tree_leaves(whole)]
    resid = [torch.randn(w.shape, generator=gen) * 1e-4
             for w in tree_leaves(whole)]
    from repro_torch.train.sharding import shard_leaf, spec_axes
    sg = [shard_leaf(mesh, g, s) for g, s in zip(grads, specs)]
    sr = [shard_leaf(mesh, r, s) for r, s in zip(resid, specs)]
    got = ef_compress_tree(sg, sr, mesh=mesh,
                           axes=[spec_axes(s) for s in specs])
    want = ef_compress_tree(grads, resid)
    diff = 0.0
    for g_list, w_list in zip(got, want):
        for x, y, s in zip(g_list, w_list, specs):
            diff = max(diff, float((gather_leaf(mesh, x, s) - y).abs().max()))
    return diff


def _flat(tree):
    return [x.detach().numpy().copy() for x in tree_flatten(tree)[0]]


def checkpoint_cases(rank: int, root: str, ref_dir: str):
    """Save on (2, 2) after one step; restore on (1, 2) over ranks 0-1
    and on (1, 1) over rank 0 (unsharded); restore the reference's
    checkpoint in ``ref_dir`` on (2, 2). Returns the whole trees each
    restore gives (rank 0), and the saved ones."""
    from repro_torch.train import restore_checkpoint, save_checkpoint
    cpu = Engine("torch:device=cpu")
    cfg = get_config("qwen3-8b", smoke=True)
    model = build_model(cfg, engine=cpu)
    opt = AdamWConfig(**OPT)
    whole = abstract_params(cfg, torch.float32)
    out = {}

    def specs_on(mesh):
        ps, os_, _ = train_state_specs(mesh, whole)
        return {"params": ps, "opt": os_}

    def gathered(mesh, tree, specs):
        n = len(tree_leaves(tree))
        return [gather_leaf(mesh, x, s).numpy().copy()
                for x, s in zip(tree_leaves(tree), spec_leaves(specs, n))]

    m22 = mesh_over_ranks((2, 2), AXES)
    m12 = mesh_over_ranks((1, 2), AXES, [0, 1])
    step, init_fn, _ = make_train_step(model, opt, m22)
    p, o, r = init_fn(0)
    p, o, r, _ = step(p, o, r, stream(cfg)(0))
    tree = {"params": p, "opt": o}
    save_checkpoint(root, 1, tree, mesh=m22, specs=specs_on(m22))
    out["saved"] = gathered(m22, tree, specs_on(m22))

    if m12.comm is not None:
        _, init12, _ = make_train_step(model, opt, m12)
        p12, o12, _ = init12(0)
        back, s = restore_checkpoint(root, {"params": p12, "opt": o12},
                                     mesh=m12, specs=specs_on(m12))
        out["on_1x2"] = gathered(m12, back, specs_on(m12))
        out["on_1x2_step"] = s
        out["requires_grad"] = all(x.requires_grad
                                   for x in tree_leaves(back["params"]))
    if rank == 0:
        _, init11, _ = make_train_step(model, opt)
        p11, o11, _ = init11(0)
        back, _ = restore_checkpoint(root, {"params": p11, "opt": o11})
        out["on_1x1"] = _flat(back)

    like = {"params": p, "opt": o}
    back, s = restore_checkpoint(ref_dir, like, mesh=m22,
                                 specs=specs_on(m22))
    out["reference_on_2x2"] = gathered(m22, back, specs_on(m22))
    out["shard_shapes"] = [tuple(x.shape) for x in tree_leaves(back)]
    out["like_shapes"] = [tuple(x.shape) for x in tree_leaves(like)]
    return out


ARCHS = ("deepseek-7b", "qwen3-8b", "gemma2-9b", "granite-20b",
         "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "pixtral-12b",
         "recurrentgemma-9b", "rwkv6-7b", "whisper-small")


def indivisible_cases(rank: int):
    """Every architecture's smoke config on a model axis of 3 over ranks
    0-2 (4 query heads, and RWKV's 4 heads of 16, do not split 3 ways;
    nor does d_model 64), and qwen3-8b with 6 query heads over 2 KV heads
    on it (2 query heads a rank do not align with groups of 3): the loss
    and the gathered gradients of one batch against one rank from the
    same parameters. ``{case: (loss error, worst gradient error)}`` on
    ranks 0-2, relative (the gradients to each leaf's norm)."""
    cpu = Engine("torch:device=cpu")
    mesh = mesh_over_ranks((1, 3), AXES, [0, 1, 2])
    if mesh.comm is None:
        return None
    out = {}
    for name in ARCHS + ("qwen3-8b-6x2",):
        cfg = smoke_config(name)
        model = build_model(cfg, engine=cpu)
        whole = model.init(0)
        for x in tree_leaves(whole):
            x.requires_grad_()
        batch = stream(cfg)(0)
        want_loss, want = _unsharded_grads(model, whole, batch)
        ps, _, _ = train_state_specs(mesh, abstract_params(cfg))
        specs = spec_leaves(ps, len(want))
        params = model.init(0, mesh=mesh)
        _start_from(mesh, tree_leaves(whole), params, specs)
        for x in tree_leaves(params):
            x.requires_grad_()
        loss, got = _sharded_grads(model, mesh, params, batch, specs)
        out[name] = (abs(loss - want_loss) / abs(want_loss),
                     max(rel(a, b) for a, b in zip(got, want)))
    return out


def _grads(fn, inputs: list, leaves: list, seed: int):
    """``fn(*inputs)`` and the gradients of its dot with a seeded
    cotangent with respect to ``inputs + leaves``."""
    for x in inputs + leaves:
        x.requires_grad_()
    y = fn(*inputs)
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed))
    grads = torch.autograd.grad((y * cot).sum(), inputs + leaves)
    return y.detach(), [g.detach() for g in grads]


def _whole_block(cfg, kind: str, seed: int):
    """One block's whole parameters of ``kind``, drawn from ``seed``."""
    from repro_torch.models.blocks import init_block
    from repro_torch.models.layers import Initializer
    return init_block(cfg, Initializer(torch.Generator().manual_seed(seed)),
                      kind)


def _placed(mesh, tree):
    """This rank's shards of the whole block ``tree`` by the rules, each
    a fresh leaf."""
    from repro_torch.train.sharding import param_shardings, shard_tree
    from repro_torch.tree import tree_map
    return shard_tree(mesh, tree_map(lambda v: v.detach().clone(), tree),
                      param_shardings(mesh, tree))


def _leaf_errs(mesh, got: list, want: list, tree) -> float:
    """The worst relative error of the gradients ``got`` (this rank's
    shards of ``tree``'s leaves), gathered, against the whole ``want``."""
    from repro_torch.train.sharding import param_shardings
    specs = spec_leaves(param_shardings(mesh, tree), len(want))
    return max(rel(gather_leaf(mesh, a, sp), b)
               for a, b, sp in zip(got, want, specs))


def _piece(mesh, fn, whole, inputs, seed):
    """``fn(params, *inputs, tp)`` on this rank's shards of ``whole``
    against ``fn(whole, *inputs, None)``: the worst relative errors of
    the output, the inputs' gradients and the leaves' (gathered) under a
    seeded cotangent."""
    tp = mesh.comm.axis(("model",))
    mine = _placed(mesh, whole)
    n = len(inputs)
    want, wg = _grads(lambda *a: fn(whole, *a, None),
                      [x.clone() for x in inputs], tree_leaves(whole), seed)
    got, gg = _grads(lambda *a: fn(mine, *a, tp),
                     [x.clone() for x in inputs], tree_leaves(mine), seed)
    return {"out": rel(got, want),
            "inputs": max(rel(a, b) for a, b in zip(gg[:n], wg[:n])),
            "leaves": _leaf_errs(mesh, gg[n:], wg[n:], whole)}


def rwkv_norm_piece(mesh, seed: int = 21):
    """RWKV-6's time mix (:func:`_rwkv_time_mix`) on this rank's heads
    against one rank (:func:`_piece`; its wkv state gathered into the
    output). The value projection of the first rank's heads is scaled by
    10 and the norm's scale ramps over the channels, so a group-norm
    proxy over one rank's channels alone would be far off the whole
    ``d_model``'s."""
    from repro_torch.models.blocks import _rwkv_time_mix
    cfg = get_config("rwkv6-7b", smoke=True)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    tp = mesh.comm.axis(("model",))
    keys = ("mix", "wr", "wk", "wv", "wg", "wa", "wb", "w0", "u", "gn", "wo")
    whole = {k: v for k, v in _whole_block(cfg, "r", seed).items()
             if k in keys}
    whole["wv"][:, :d // tp.size] *= 10.0
    whole["gn"] += torch.linspace(-0.5, 0.5, d)
    g = torch.Generator().manual_seed(seed + 1)
    nh = d // hd
    inputs = [torch.randn((2, 5, d), generator=g),
              torch.randn((2, 5, d), generator=g),
              torch.randn((2, nh, hd, hd), generator=g) * 0.1]

    def fn(p, xn, xprev, wkv, tp):
        if tp is not None:           # this rank's heads of the state
            n = nh // tp.size
            wkv = dist.copy_to_parallel(wkv, tp.group)[
                :, tp.index * n:(tp.index + 1) * n]
        y, last = _rwkv_time_mix(cfg, p, xn, xprev, wkv, tp)
        if tp is not None:
            last = dist.gather_out_of_parallel(last, tp.group, 1)
        return torch.cat([y.flatten(), last.flatten()])
    return _piece(mesh, fn, whole, inputs, seed)


def channel_gate_piece(mesh, seed: int = 23):
    """RWKV-6's channel mix (:func:`_rwkv_channel_mix`: ``cr``'s gate of
    this rank's channels gathered whole to meet ``cv``'s summed product)
    against one rank (:func:`_piece`)."""
    from repro_torch.models.blocks import _rwkv_channel_mix
    cfg = get_config("rwkv6-7b", smoke=True)
    whole = {k: v for k, v in _whole_block(cfg, "r", seed).items()
             if k in ("cmix", "ck", "cv", "cr")}
    g = torch.Generator().manual_seed(seed + 1)
    inputs = [torch.randn((2, 5, cfg.d_model), generator=g)
              for _ in range(2)]
    return _piece(mesh, lambda p, x, xprev, tp: _rwkv_channel_mix(
        cfg, p, x, xprev, tp), whole, inputs, seed)


def mlp_width_piece(mesh, seed: int = 25):
    """deepseek-moe-16b smoke with two shared experts (an MLP of 256
    columns) and its dense block ``d`` (``d_ff_dense`` 64), neither of
    ``d_ff`` 128's width: the shared MLP and the ``d`` block
    (``apply_block``) on this rank's columns against one rank
    (:func:`_piece`)."""
    from repro_torch.models.blocks import _apply_mlp, apply_block
    cfg = get_config("deepseek-moe-16b", smoke=True)
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, n_shared=2))
    g = torch.Generator().manual_seed(seed)
    inputs = [torch.randn((2, 5, cfg.d_model), generator=g)]
    pos = torch.arange(5)[None].expand(2, 5)
    width = cfg.d_ff * cfg.moe.n_shared
    return {
        "shared": _piece(mesh, lambda p, x, tp: _apply_mlp(
            cfg, p, x, d_ff=width, tp=tp),
            _whole_block(cfg, "m", seed)["shared"], inputs, seed),
        "d": _piece(mesh, lambda p, x, tp: apply_block(
            cfg, "d", p, x, pos=pos, tp=tp)[0],
            _whole_block(cfg, "d", seed + 1), inputs, seed)}


def tp_pieces(rank: int):
    """The new tensor-parallel pieces on (1, 2) over ranks 0-1 and (1, 4)
    over all four: ``{(model axis, piece): errors}``."""
    out = {}
    for shape, ranks in (((1, 2), [0, 1]), ((1, 4), [0, 1, 2, 3])):
        mesh = mesh_over_ranks(shape, AXES, ranks)
        if mesh.comm is None:
            continue
        out[shape[1], "rwkv_norm"] = rwkv_norm_piece(mesh)
        out[shape[1], "channel_gate"] = channel_gate_piece(mesh)
        for name, errs in mlp_width_piece(mesh).items():
            out[shape[1], "mlp_width_" + name] = errs
    return out


def pim_train_case(rank: int):
    """qwen3-8b smoke on the PIM path, on (2, 1) over ranks 0-1 and
    (1, 2) over ranks 2-3, with the LM head alone and with every block
    projection too: ``model.loss`` under ``pim_linear_mode="pim"``
    (each data rank's share summed), and one train step under
    ``"fake"`` (loss and grad_norm), against one rank. Returns the
    rank's mesh and ``{(mode, block mode): (sharded, one rank)}``."""
    import dataclasses
    cpu = Engine("torch:device=cpu")
    meshes = [mesh_over_ranks((2, 1), AXES, [0, 1]),
              mesh_over_ranks((1, 2), AXES, [2, 3])]
    mesh = next(m for m in meshes if m.comm is not None)
    base = get_config("qwen3-8b", smoke=True)
    batch = stream(base)(0)
    dp = mesh.comm.axis(("data",))
    rows = batch["tokens"].shape[0] // dp.size
    mine = {k: v[dp.index * rows:(dp.index + 1) * rows]
            for k, v in batch.items()}
    out = {}
    for blocks in ("none", "full"):
        model = build_model(dataclasses.replace(
            base, pim_linear_mode="pim", pim_block_mode=blocks), engine=cpu)
        with torch.no_grad():
            share = model.loss(model.init(0, mesh=mesh), mine, mesh)
            out["pim", blocks] = (
                [float(dist.all_reduce(share.clone(), dp.group))],
                [float(model.loss(model.init(0), batch))])
        model = build_model(dataclasses.replace(
            base, pim_linear_mode="fake", pim_block_mode=blocks),
            engine=cpu)
        runs = []
        for m in (mesh, None):
            step, init_fn, _ = make_train_step(model, AdamWConfig(**OPT), m)
            *_, metrics = step(*init_fn(0), batch)
            runs.append([float(metrics["loss"]),
                         float(metrics["grad_norm"])])
        out["fake", blocks] = tuple(runs)
    return mesh.axis_sizes, out


def _fault_in(kind: str, step_of, fail_at: int, nth: int = 2,
              before_kill=None):
    """A stand-in for ``repro_torch.dist.all_reduce`` on the failing
    rank: at step ``fail_at`` (``step_of()``), the ``nth`` all-reduce of
    the forward (``kind`` "forward") or of the backward ("backward", one
    called from a ``backward``) raises, once, before it enters the
    collective, so the other ranks are left waiting in it; with
    ``kind`` "kill" the process is SIGKILLed there instead, after
    ``before_kill()``. Returns the stand-in and a list that holds the
    step once it fired."""
    import signal
    import traceback
    real, seen, fired = dist.all_reduce, [], []

    def all_reduce(x, group, op="sum"):
        if step_of() == fail_at and not fired:
            backward = any(f.name == "backward"
                           for f in traceback.extract_stack())
            if backward == (kind == "backward"):
                seen.append(1)
                if len(seen) == nth:
                    fired.append(fail_at)
                    if kind == "kill":
                        before_kill()
                        os.kill(os.getpid(), signal.SIGKILL)
                    raise RuntimeError(f"simulated fault in the {kind} "
                                       f"of step {fail_at}")
        return real(x, group, op)
    return all_reduce, fired


def _runner(cfg, mesh, step, ckpt_dir, batch_at, seen, taken):
    from repro_torch.train import RetryingRunner
    whole = abstract_params(cfg)
    ps, os_, _ = train_state_specs(mesh, whole)

    def batch_fn(s):
        taken["step"] = s
        return batch_at(s)

    def step_fn(*state):
        new = step(*state)
        seen.append((taken["step"], float(new[3]["loss"])))
        return new
    return RetryingRunner(step_fn=step_fn, batch_fn=batch_fn,
                          ckpt_dir=ckpt_dir, ckpt_every=2, mesh=mesh,
                          specs={"params": ps, "opt": os_})


def runner_case(rank: int, root: str, fail_rank: int = 3,
                fail_at: int = 3, steps: int = 5):
    """``RetryingRunner`` on (2, 2), checkpointing every 2 steps, run
    from the same parameters: once uninterrupted; once with mesh rank
    ``fail_rank`` alone raising before step ``fail_at``; once the same
    with no fence armed (``unfenced``: the ranks agree between the
    phases of a step, as they do on a backend other than gloo); and
    once each with it raising between two all-reduces of that step's
    forward, and of its backward, while the other ranks wait in a
    collective. Returns
    each run's ``(step, loss)`` for every step taken, its restarts, its
    recoveries' seconds, its wall seconds, whether the fault fired, and
    (on rank 0) its gathered final parameters."""
    cpu = Engine("torch:device=cpu")
    cfg = get_config("qwen3-8b", smoke=True)
    model = build_model(cfg, engine=cpu)
    mesh = mesh_over_ranks((2, 2), AXES)
    step, init_fn, _ = make_train_step(model, AdamWConfig(**OPT), mesh)
    ps, _, _ = train_state_specs(mesh, abstract_params(cfg))
    pspecs = spec_leaves(ps, len(tree_leaves(abstract_params(cfg))))
    batch_at = stream(cfg)
    out = {}
    for name in ("whole", "before", "unfenced", "forward", "backward"):
        seen, taken, fired = [], {"step": -1}, []

        def inject(s):
            if (name in ("before", "unfenced") and rank == fail_rank
                    and s == fail_at and not fired):
                fired.append(s)
                raise RuntimeError(f"simulated loss of rank {rank}")

        runner = _runner(cfg, mesh, step, os.path.join(root, name),
                         batch_at, seen, taken)
        real, supported = dist.all_reduce, vars(dist.Fence)["supported"]
        if name in ("forward", "backward") and rank == fail_rank:
            dist.all_reduce, fired = _fault_in(name, lambda: taken["step"],
                                               fail_at)
        if name == "unfenced":
            dist.Fence.supported = staticmethod(lambda group: False)
        t0 = time.monotonic()
        try:
            (params, _, _), metrics = runner.run(init_fn(0), 0, steps,
                                                 inject_failure=inject)
        finally:
            dist.all_reduce, dist.Fence.supported = real, supported
        final = [gather_leaf(mesh, x, sp).numpy().copy()
                 for x, sp in zip(tree_leaves(params), pspecs)]
        out[name] = {"seen": seen, "restarts": metrics["restarts"],
                     "recovery_s": metrics["recovery_s"],
                     "wall_s": time.monotonic() - t0, "fired": fired,
                     "final": final if rank == 0 else None}
    return out


def kill_case(rank: int, root: str, fail_at: int = 3, steps: int = 6):
    """qwen3-8b smoke on (2, 2), batches of 12, checkpoints every 2
    steps. On every rank an uninterrupted ``RetryingRunner`` run
    (``whole``); then the same run with rank 3 SIGKILLed at its second
    all-reduce of step ``fail_at``'s forward. Ranks 0-2 must raise
    ``RanksLost`` naming rank 3; each then re-meshes with
    ``elastic_remesh`` (to (3, 1)), restores the newest checkpoint
    sharded for it and trains on to ``steps``. Returns, on ranks 0-2,
    the whole run's losses, the lost ranks, the error and its seconds
    after the kill,
    the new mesh, the restored step and the losses after it."""
    from repro_torch.train import restore_checkpoint
    from repro_torch.train.fault import RanksLost, elastic_remesh
    cpu = Engine("torch:device=cpu")
    cfg = get_config("qwen3-8b", smoke=True)
    model = build_model(cfg, engine=cpu)
    mesh = mesh_over_ranks((2, 2), AXES)
    step, init_fn, _ = make_train_step(model, AdamWConfig(**OPT), mesh)
    batch_at = stream(cfg, batch=12)
    seen, taken = [], {"step": -1}
    runner = _runner(cfg, mesh, step, os.path.join(root, "whole"), batch_at,
                     seen, taken)
    runner.run(init_fn(0), 0, steps)
    out = {"whole": seen}
    taken["step"], killed = -1, []
    runner = _runner(cfg, mesh, step, os.path.join(root, "killed"),
                     batch_at, [], taken)
    stamp = os.path.join(root, "killed_at")
    if rank == 3:
        def before_kill():
            with open(stamp, "w") as f:
                f.write(repr(time.monotonic()))
        dist.all_reduce, _ = _fault_in("kill", lambda: taken["step"],
                                       fail_at, before_kill=before_kill)
    try:
        runner.run(init_fn(0), 0, steps)
    except RanksLost as e:
        killed.append((e.ranks, str(e), time.monotonic()))
    if not killed:
        raise AssertionError("the run went on without rank 3")
    out["lost"], out["error"] = killed[0][:2]
    with open(stamp) as f:
        out["noticed_s"] = killed[0][2] - float(f.read())
    survivors = elastic_remesh([0, 1, 2], model_parallel=2)
    step2, init2, _ = make_train_step(model, AdamWConfig(**OPT), survivors)
    ps, os_, _ = train_state_specs(survivors, abstract_params(cfg))
    params, opt, res = init2(0)
    back, at = restore_checkpoint(os.path.join(root, "killed"),
                                  {"params": params, "opt": opt},
                                  mesh=survivors,
                                  specs={"params": ps, "opt": os_})
    params, opt = back["params"], back["opt"]
    losses = []
    for s in range(at, steps):
        params, opt, res, met = step2(params, opt, res, batch_at(s))
        losses.append((s, float(met["loss"])))
    out.update(mesh=survivors.shape, restored=at, after=losses)
    return out


def misc_cases(rank: int, stacked, root: str, ref_dir: str):
    """The world-4 group of ``tests/test_torch_sharded.py``'s other
    checks."""
    return {"psum": psum_case(rank, stacked),
            "compress": compress_case(rank),
            "ckpt": checkpoint_cases(rank, root, ref_dir),
            "indivisible": indivisible_cases(rank),
            "tp_pieces": tp_pieces(rank),
            "pim_train": pim_train_case(rank),
            "runner": runner_case(rank, os.path.join(root, "runner"))}


def elastic_case(rank: int, init_ckpt: str, ckpt_dir: str):
    """The elastic schedule (``repro_torch.launch.elastic``) of
    deepseek-7b smoke on the CPU: (4, 2), then the first 4 ranks re-meshed
    to (2, 2), from the reference's initial parameters."""
    from repro_torch.launch.elastic import run_schedule
    model = build_model(get_config("deepseek-7b", smoke=True),
                        engine=Engine("torch:device=cpu"))
    return run_schedule(model, model_parallel=2, survivors=4, steps=4,
                        more=3, ckpt_dir=ckpt_dir, init_ckpt=init_ckpt)
