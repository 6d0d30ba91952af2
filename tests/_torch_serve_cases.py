"""What each rank runs in ``tests/test_torch_serve_sharded.py`` (no JAX
here: a spawned rank imports this module).

:func:`serve_cases` holds sharded serving against one rank on every
rank of each case's mesh, both from the reference's initial parameters
(a pickled numpy tree, through ``convert.params_from_numpy``): prefill
and greedy decode steps through ``make_serve_step``, the tokens, the
logits (gathered over the vocabulary and the rows) and the caches
(gathered by their specs) after prefill and after every step, and each
rank's placed parameter and decode-state bytes. :func:`piece_cases`
holds the pieces: the argmax over vocabulary shards, the
sequence-sharded attention combine, the PIM scales and row-parallel
product on shards, the shard-by-shard init, the expert-parallel PIM
dispatch's scales and rows, and a windowed ring split over the
sequence.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from _torch_sharded_cases import SCALED, smoke_config  # noqa: F401
from repro_torch import dist
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.engine import Engine
from repro_torch.launch.mesh import mesh_over_ranks
from repro_torch.models import build_model
from repro_torch.models.attention import KVCache, decode_attend
from repro_torch.models.transformer import encode
from repro_torch.train import make_prefill, make_serve_step
from repro_torch.train.sharding import (gather_tree, param_shardings,
                                        shard_leaf, shard_tree,
                                        state_shardings)
from repro_torch.train.step import batch_rows, gather_rows, greedy_token
from repro_torch.tree import tree_leaves

AXES = ("data", "model")
PROMPT, CACHE, STEPS = 8, 32, 4


def config(arch: str, pim: bool):
    """``arch``'s smoke config (or a variant of ``SCALED``); with ``pim``
    every projection on the PIM path at 8 bits."""
    cfg = smoke_config(arch)
    if pim:
        cfg = dataclasses.replace(cfg, pim_linear_mode="pim",
                                  pim_linear_bits=8, pim_block_mode="full")
    return cfg


def inputs(cfg, batch: int, seed: int = 0):
    """Seeded prompts (batch, PROMPT) and, for enc-dec, frames (numpy)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(3, cfg.vocab_size, (batch, PROMPT))
    frames = None
    if cfg.family == "encdec":
        frames = rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return prompts, frames


def reference_params(init_dir: str, arch: str):
    """The reference's ``init(PRNGKey(0))`` of ``arch``, pickled as a
    numpy tree in ``init_dir``, as the port's tree."""
    with open(os.path.join(init_dir, f"{arch}.pkl"), "rb") as f:
        return params_from_numpy(pickle.load(f))


def _whole_logits(cfg, logits, mesh, dp):
    """The last position's logits of every row over the whole
    vocabulary."""
    last = logits[:, -1]
    if last.shape[-1] != cfg.vocab_size:
        last = dist.all_gather(last, mesh.comm.axis(("model",)).group,
                               dim=-1)
    return gather_rows(last, dp)


def greedy(model, params, prompts, frames, mesh=None):
    """Prefill and STEPS greedy steps through ``make_serve_step`` (the
    launcher's loop). Returns (tokens (B, STEPS + 1), the whole logits
    and whole states after prefill and after each step, this rank's
    placed parameter and decode-state bytes, as placed)."""
    cfg = model.cfg
    b = prompts.shape[0]
    rows, dp = batch_rows(mesh, b)
    states = model.init_decode_state(b, CACHE, mesh=mesh)
    specs = (state_shardings(mesh, model.init_decode_state(b, CACHE))
             if mesh is not None else None)

    def whole_states(st):
        if mesh is not None:      # (a prefill's states keep no enc_out)
            st = gather_tree(mesh, st, {k: specs[k] for k in st})
        return [x.detach().clone() for x in tree_leaves(st)]
    nbytes = [sum(x.numel() * x.element_size() for x in tree_leaves(t))
              for t in (params, states)]
    if frames is not None:
        states["enc_out"] = encode(cfg, params, rows(frames),
                                   engine=model.engine, mesh=mesh)
    logits, states = model.forward(params, rows(prompts), states=states,
                                   mesh=mesh)
    tok = gather_rows(greedy_token(cfg, logits, mesh), dp)
    toks, seen = [tok], [(_whole_logits(cfg, logits, mesh, dp),
                          whole_states(states))]
    last = {}

    def capture(p, token, position, st, mesh=None):
        out = model.decode_step(p, token, position, st, mesh=mesh)
        last["logits"] = out[0]
        return out
    serve, _ = make_serve_step(dataclasses.replace(model,
                                                   decode_step=capture), mesh)
    pos0 = torch.full((b, 1), prompts.shape[1], dtype=torch.int32)
    for t in range(STEPS):
        tok, states = serve(params, states, tok, pos0 + t)
        toks.append(tok)
        seen.append((_whole_logits(cfg, last["logits"], mesh, dp),
                     whole_states(states)))
    return torch.cat(toks, dim=1), seen, nbytes


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def serve_cases(rank: int, cases, init_dir: str, placement):
    """Each case ``(arch, (dp, tp), pim, batch)`` on the ranks
    ``placement[(dp, tp)]`` (None on the others): the sharded run
    against one rank's from the same parameters and prompts. Returns,
    for each, ``tokens_equal``, ``prefill_equal`` (``make_prefill`` on
    the mesh gives one rank's first token), the worst logit error
    relative to one rank's largest logit (``logits``), the worst cache
    error relative to each leaf's largest value (``caches``), the placed
    ``bytes``, the sharded tokens and, on the mesh's first rank, the
    final states."""
    cpu = Engine("torch:device=cpu")
    meshes = {shape: mesh_over_ranks(shape, AXES, ranks)
              for shape, ranks in placement}
    out = []
    for arch, shape, pim, batch in cases:
        mesh = meshes[shape]
        if mesh.comm is None:
            out.append(None)
            continue
        cfg = config(arch, pim)
        model = build_model(cfg, engine=cpu)
        whole = reference_params(init_dir, arch)
        prompts, frames = inputs(cfg, batch)
        prompts = torch.from_numpy(prompts)
        frames = None if frames is None else torch.from_numpy(frames)
        want, want_seen, _ = greedy(model, whole, prompts, frames)
        params = shard_tree(mesh, whole, param_shardings(mesh, whole))
        del whole
        got, got_seen, nbytes = greedy(model, params, prompts, frames, mesh)
        first = make_prefill(model, mesh)[0](params, {"tokens": prompts})
        res = {"tokens_equal": bool(torch.equal(got, want)),
               "prefill_equal": bool(torch.equal(first, want[:, :1])),
               "tokens": got.numpy(), "bytes": nbytes,
               "logits": 0.0, "caches": 0.0, "final_states": None}
        for (gl, gs), (wl, ws) in zip(got_seen, want_seen):
            res["logits"] = max(res["logits"], _max_rel(gl, wl))
            res["caches"] = max(res["caches"], max(
                _max_rel(a, b) for a, b in zip(gs, ws)))
        if not any(mesh.comm.coords):
            res["final_states"] = [x.numpy() for x in got_seen[-1][1]]
        out.append(res)
    return out


def argmax_piece(mesh):
    """The greedy token over vocabulary shards with ties planted: row 0's
    maximum at the last index of shard 0 and the first of shard 1 (and in
    shard 3), row 1's only in shard 2, row 2's twice inside shard 1.
    Returns (sharded tokens, torch.argmax of the whole)."""
    cfg = get_config("gemma2-9b", smoke=True)
    g = torch.Generator().manual_seed(4)
    whole = torch.randn((3, 1, cfg.vocab_size), generator=g)
    n = cfg.vocab_size // mesh.shape["model"]
    whole[0, 0, [n - 1, n, 3 * n + 5]] = 9.0
    whole[1, 0, 2 * n + 7] = 9.0
    whole[2, 0, [n + 3, n + 9]] = 9.0
    tp = mesh.comm.axis(("model",))
    mine = whole[..., tp.index * n:(tp.index + 1) * n]
    got = greedy_token(cfg, mine, mesh)
    return got[:, 0].tolist(), torch.argmax(whole[:, -1], dim=-1).tolist()


def combine_piece(mesh):
    """``decode_attend`` over a 32-slot ring split over the model axis
    (sequence sharding) against it on the whole cache, with a window of
    12 and a softcap of 50, at a length past a wrap of the ring. Returns
    the worst relative error of the output and of the gathered cache."""
    from repro_torch.models.attention import decode_attend_split
    g = torch.Generator().manual_seed(6)
    b, t, hq_all, hkv, d = 2, 32, 8, 1, 16
    tp = mesh.comm.axis(("model",))
    q = torch.randn((b, 1, hq_all, d), generator=g)
    k0 = torch.randn((b, t, hkv, d), generator=g)
    v0 = torch.randn((b, t, hkv, d), generator=g)
    kn = torch.randn((b, 1, hkv, d), generator=g)
    vn = torch.randn((b, 1, hkv, d), generator=g)
    length = torch.tensor(45, dtype=torch.int32)
    want, wc = decode_attend(q, KVCache(k0.clone(), v0.clone(), length),
                             kn, vn, window=12, cap=50.0)
    t_l, hq = t // tp.size, hq_all // tp.size
    sl = slice(tp.index * t_l, (tp.index + 1) * t_l)
    cache = KVCache(k0[:, sl].clone(), v0[:, sl].clone(), length)
    got, gc = decode_attend_split(q[:, :, tp.index * hq:(tp.index + 1) * hq],
                                  cache, kn, vn, tp.group, tp.index,
                                  tp.size, window=12, cap=50.0)
    got = dist.all_gather(got, tp.group, dim=2)
    errs = [_max_rel(got, want),
            _max_rel(dist.all_gather(gc.k, tp.group, dim=1), wc.k),
            _max_rel(dist.all_gather(gc.v, tp.group, dim=1), wc.v)]
    return errs, int(gc.length) == int(wc.length)


def quant_piece(mesh):
    """A row-parallel PIM projection on (data, model) shards: ``x``'s
    rows over ``data`` and its inner dimension over ``model``, ``w``'s
    rows over ``model``. Returns whether the shards' reduced amaxes are
    the whole tensors' and whether ``Engine.linear`` in ``pim`` mode
    equals one rank's rows bit for bit (and the float product within
    float noise)."""
    from repro_torch.pim.quant import amax_of
    eng = Engine("torch:device=cpu")
    g = torch.Generator().manual_seed(8)
    x = torch.randn((4, 3, 64), generator=g)
    w = torch.randn((64, 24), generator=g) * 0.1
    data = mesh.comm.axis(("data",))
    model = mesh.comm.axis(("model",))
    xs = shard_leaf(mesh, x, ("data", None, "model"))
    ws = shard_leaf(mesh, w, ("model", None))
    both = mesh.comm.axis(("data", "model")).group
    xa = dist.max_from_parallel(amax_of(xs), both)
    wa = dist.max_from_parallel(amax_of(ws, 0), model.group)
    scales = bool(torch.equal(xa, amax_of(x))
                  and torch.equal(wa, amax_of(w, 0)))
    rows = slice(data.index * 2, (data.index + 1) * 2)
    want = eng.linear(x, w, n_bits=8, mode="pim")[rows]
    got = eng.linear(xs, ws, n_bits=8, mode="pim", x_group=data.group,
                     k_group=model.group)
    fl = eng.linear(xs, ws, mode="float", k_group=model.group)
    return scales, bool(torch.equal(got, want)), _max_rel(fl, (x @ w)[rows])


def ragged_piece(mesh):
    """Expert parallelism on (2, 2): 16 tokens (their rows over
    ``data``), each routed to 2 of 4 experts (the experts over
    ``model``), through ``Engine.ragged_linear`` in ``pim`` mode with
    ``x_group``/``k_group``, against one rank's dispatch of every pair:
    each rank's rows equal one rank's rows of the same (token, expert)
    pairs bit for bit, its scales are the whole stack's and every routed
    row's. Once more with every pair routed to the first model rank's
    experts, so the other holds no row. Returns ``[(scales equal, rows
    equal, rows), ...]``."""
    from repro_torch.pim.quant import amax_of
    eng = Engine("torch:device=cpu")
    g = torch.Generator().manual_seed(10)
    t, k, e, d, f = 16, 2, 4, 24, 8
    x = torch.randn((t, d), generator=g)
    we = torch.randn((e, d, f), generator=g) * 0.1
    data = mesh.comm.axis(("data",))
    model = mesh.comm.axis(("model",))
    rows, n = t // data.size, e // model.size
    out = []
    for idx in (torch.stack([torch.randperm(e, generator=g)[:k]
                             for _ in range(t)]),
                torch.randint(0, n, (t, k), generator=g)):
        flat_e = idx.reshape(-1)
        flat_t = torch.arange(t).repeat_interleave(k)
        order = torch.argsort(flat_e, stable=True)
        counts = torch.bincount(flat_e, minlength=e)
        want = eng.ragged_linear(x[flat_t[order]], we, counts, n_bits=8,
                                 mode="pim")
        st, se = flat_t[order], flat_e[order]
        keep = ((st // rows == data.index) & (se // n == model.index))
        mine = torch.bincount(se[keep] - model.index * n, minlength=n)
        xs = x[st[keep]]
        ws = we[model.index * n:(model.index + 1) * n]
        got = eng.ragged_linear(xs, ws, mine, n_bits=8, mode="pim",
                                x_group=data.group, k_group=model.group)
        both = mesh.comm.axis(("data", "model")).group
        xa = dist.max_from_parallel(amax_of(xs), both)
        wa = dist.max_from_parallel(amax_of(ws), model.group)
        scales = bool(torch.equal(xa, amax_of(x[flat_t]))
                      and torch.equal(wa, amax_of(we)))
        out.append((scales, bool(torch.equal(got, want[keep])),
                    int(keep.sum())))
    return out


def ring_piece(mesh, window: int = 12, prompt: int = 16, steps: int = 6):
    """recurrentgemma-9b smoke with a window of 12 under a cache of 32:
    its local-attention layer keeps a ring of 12 slots, which its single
    KV head leaves to split over the sequence, 12 / tp slots a rank. A
    prompt of 16 (past the window: the prefill rotates its last 12
    tokens into the ring) and 6 greedy steps (the ring wraps) on this
    mesh against one rank. Returns (tokens equal, worst logit error, the
    worst error of the gathered caches)."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              window=window)
    model = build_model(cfg, engine=Engine("torch:device=cpu"))
    whole = model.init(0)
    params = shard_tree(mesh, whole, param_shardings(mesh, whole))
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, prompt)))
    specs = state_shardings(mesh, model.init_decode_state(2, CACHE))
    runs = []
    for p, m in ((whole, None), (params, mesh)):
        states = model.init_decode_state(2, CACHE, mesh=m)
        with torch.no_grad():
            logits, states = model.forward(p, prompts, states=states, mesh=m)
            toks, seen = [greedy_token(cfg, logits, m)], [logits[:, -1]]
            for i in range(steps):
                pos = torch.full((2, 1), prompt + i, dtype=torch.int32)
                logits, states = model.decode_step(p, toks[-1], pos, states,
                                                   mesh=m)
                toks.append(greedy_token(cfg, logits, m))
                seen.append(logits[:, -1])
        if m is not None:
            seen = [dist.all_gather(x, m.comm.axis(("model",)).group, dim=-1)
                    for x in seen]
            states = gather_tree(m, states, {k: specs[k] for k in states})
        runs.append((torch.cat(toks, dim=1), seen, tree_leaves(states)))
    (tw, lw, cw), (tg, lg, cg) = runs
    return (bool(torch.equal(tg, tw)),
            max(_max_rel(a, b) for a, b in zip(lg, lw)),
            max(_max_rel(a, b) for a, b in zip(cg, cw)))


def init_piece(mesh, archs):
    """For each arch, whether ``model.init(0, mesh=mesh)`` equals
    ``shard_leaf`` of the whole ``model.init(0)``, leaf for leaf."""
    cpu = Engine("torch:device=cpu")
    out = {}
    for arch in archs:
        model = build_model(get_config(arch, smoke=True), engine=cpu)
        whole = model.init(0)
        want = tree_leaves(shard_tree(mesh, whole,
                                      param_shardings(mesh, whole)))
        got = tree_leaves(model.init(0, mesh=mesh))
        out[arch] = len(got) == len(want) and all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, want))
    return out


def piece_cases(rank: int, archs):
    """The pieces on a world of 4: the argmax and the combine on (1, 4),
    the PIM projection and the init on (2, 2)."""
    m14 = mesh_over_ranks((1, 4), AXES)
    m22 = mesh_over_ranks((2, 2), AXES)
    return {"argmax": argmax_piece(m14), "combine": combine_piece(m14),
            "quant": quant_piece(m22), "init": init_piece(m22, archs),
            "ragged": ragged_piece(m22), "ring": ring_piece(m14)}


def all_cases(rank: int, cases, init_dir: str, placement, init_archs):
    """:func:`serve_cases` and :func:`piece_cases` in one group of
    ranks."""
    return {"serve": serve_cases(rank, cases, init_dir, placement),
            "pieces": piece_cases(rank, init_archs)}
