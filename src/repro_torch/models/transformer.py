"""Model assembly: layer-pattern segmentation + a loop over stacked units.

The port's copy of ``repro.models.transformer``. The layer pattern is
decomposed into (prefix, repeating unit x n, suffix) by
:func:`stack_plan`; unit slots are stacked along a leading axis, as in
the reference, so parameter trees carry across with one tree map. The
reference's ``lax.scan`` over units is a Python loop over index ``i`` of
the stacked tensors; its ``dynamic_update_index_in_dim`` on the stacked
decode states is an in-place write into them, so a decode step updates
the caches where they lie and allocates no second copy.

Decode states keep every counter (a cache's ``length``, its ring slot) as
a device tensor: a decode step never waits for the card.

Given a mesh of ranks (``mesh=``), :func:`forward` and
:func:`decode_step` take this rank's place on it once
(:func:`repro_torch.models.blocks.tensor_parallel` on the ``model``
axis, :func:`repro_torch.models.blocks.data_parallel` on the data axes)
and hand it to every block, the encoder's too. The tokens, positions,
frames and decode states are this rank's rows (and, over ``model``, its
shards of the caches, as ``state_shardings`` places them:
:func:`init_decode_state` makes them). Over ``model`` the embedding is
vocab-parallel (a masked lookup of this rank's rows, then the sum over
ranks), the VLM's ``patch_proj`` is column-parallel with its patches
gathered whole, the blocks compute their shard, and the logits stay
sharded over the vocabulary (for the loss's vocab-parallel cross
entropy, and the greedy token's argmax over the shards,
:func:`repro_torch.train.step.greedy_token`). A leaf that the rules keep
whole (a vocabulary that does not split) is used whole. The PIM
projections take their scales over the ranks that split their operands
(:func:`repro_torch.models.blocks.pim_proj`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.tree import (DictKey, tree_flatten, tree_flatten_with_path,
                              tree_map, tree_map_with_path)

from .blocks import (WHOLE_CACHE, _engine, _group, apply_block,
                     data_parallel, init_block, init_state, tensor_parallel)
from .layers import Initializer, rms_norm, softcap

__all__ = ["stack_plan", "init_params", "forward", "decode_step",
           "init_decode_state", "encode", "head_matmul", "tree_map"]


def head_matmul(cfg: ModelConfig, x: torch.Tensor, head: torch.Tensor, *,
                engine=None, dp=None) -> torch.Tensor:
    """LM-head projection, optionally offloaded to the PIM engine.

    With ``cfg.pim_linear_mode != "off"`` the projection runs as a
    PIM-mode linear through ``engine`` (default
    :func:`repro_torch.engine.get_engine`, on the card): the Section-VI
    MAC schedule for ``cfg.pim_linear_bits`` compiles into the engine's
    program cache once, and the product is the bit-identical quantized
    integer path. This is the ``"head"`` scope; the block scopes route
    through :func:`repro_torch.models.blocks.pim_proj` on the same
    engine. ``dp``: this rank's place on the data axes, over which
    ``x``'s rows are split (its scale is the maximum over them); a
    vocab-parallel ``head`` holds whole columns, so its scales are its
    own.
    """
    if cfg.pim_linear_mode == "off":
        return x @ head
    return _engine(engine).linear(x, head, n_bits=cfg.pim_linear_bits,
                                  mode=cfg.pim_linear_mode,
                                  x_group=_group(dp))


# ------------------------------------------------------------ planning ----
def stack_plan(cfg: ModelConfig) -> Tuple[Tuple[str, ...], Tuple[str, ...],
                                          int, Tuple[str, ...]]:
    """-> (prefix_kinds, unit_kinds, n_units, suffix_kinds)."""
    kinds = list(cfg.layer_kinds())
    best = (tuple(kinds), (), 0, ())      # fallback: all prefix
    best_cost = len(kinds)
    for p in range(0, min(4, len(kinds)) + 1):
        for u in range(1, 5):
            rest = kinds[p:]
            if len(rest) < u:
                continue
            unit = rest[:u]
            n = 0
            while (n + 1) * u <= len(rest) and rest[n * u:(n + 1) * u] == unit:
                n += 1
            suffix = rest[n * u:]
            cost = p + len(suffix) + (u if n > 1 else len(kinds))
            if n > 1 and cost < best_cost:
                best = (tuple(kinds[:p]), tuple(unit), n, tuple(suffix))
                best_cost = cost
    return best


def _stack(make: Callable[[], Any], n: int):
    """``n`` trees from ``make()``, stacked along a new leading axis.
    Each tree is written into the stack as it is made, so the peak is the
    stack plus one tree (the reference stacks a list of ``n``)."""
    first = make()
    out = tree_map(lambda x: x.new_empty((n, *x.shape)), first)
    tree_map(lambda d, s: d[0].copy_(s), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda d, s: d[i].copy_(s), out, make())
    return out


def _at(tree, i: int):
    """Unit ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda s: s[i], tree)


def _put(stacked, i: int, new) -> None:
    """Write ``new`` into unit ``i`` of ``stacked`` in place; a leaf that
    already is that slot (a cache written in place) is left alone. The
    slot is recognised by its storage, offset, shape and strides, never
    by a data pointer, which a fake tensor does not have."""
    def one(dst, src):
        slot = dst[i]
        if not (slot.untyped_storage() is src.untyped_storage()
                and slot.storage_offset() == src.storage_offset()
                and slot.shape == src.shape
                and slot.stride() == src.stride()):
            slot.copy_(src)
    tree_map(one, stacked, new)


# ---------------------------------------------------------------- init ----
def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32,
                place: Optional[Callable[[Any], Any]] = None
                ) -> Dict[str, Any]:
    """The model's parameter tree, drawn from ``generator`` on its device:
    ``embed``, ``final_norm``, [``lm_head``], ``prefix``, ``scan``
    (stacked), ``suffix``, [``encoder``], [``patch_proj``].

    ``place`` (a tree of whole leaves, named as in the parameter tree,
    to this rank's shards of them) is applied to each leaf, and to each
    block's leaves, as soon as they are drawn, in the draw order of the
    whole init: the shards equal the whole init's, and only one block's
    (a stacked unit's) or one top-level leaf's whole leaves are live
    at a time."""
    ini = Initializer(generator)
    prefix, unit, n_units, suffix = stack_plan(cfg)

    def keep(tree):
        tree = tree_map(lambda x: x.to(dtype), tree)
        return tree if place is None else place(tree)

    def block(c, kind):
        return keep(init_block(c, ini, kind))
    params: Dict[str, Any] = keep({"embed": ini(
        cfg.vocab_size, cfg.d_model, scale=cfg.d_model ** -0.5,
        dtype=dtype)})
    params.update(keep({"final_norm": ini.zeros(cfg.d_model, dtype=dtype)}))
    if not cfg.tie_embeddings:
        params.update(keep({"lm_head": ini(cfg.d_model, cfg.vocab_size,
                                           scale=cfg.d_model ** -0.5,
                                           dtype=dtype)}))
    params["prefix"] = [block(cfg, k) for k in prefix]
    params["scan"] = [_stack(lambda: block(cfg, k), n_units) for k in unit]
    params["suffix"] = [block(cfg, k) for k in suffix]

    if cfg.family == "encdec":
        enc_cfg = cfg.scaled(family="decoder")  # no cross-attn weights
        params["encoder"] = {
            "blocks": _stack(lambda: block(enc_cfg, "g"), cfg.enc_layers)}
        params["encoder"].update(keep({
            "norm": ini.zeros(cfg.d_model, dtype=dtype),
            "pos": ini(cfg.enc_frames, cfg.d_model, scale=0.02,
                       dtype=dtype)}))
    if cfg.family == "vlm":
        params.update(keep({"patch_proj": ini(cfg.d_model, cfg.d_model,
                                              scale=cfg.d_model ** -0.5,
                                              dtype=dtype)}))
    return params


# ------------------------------------------------------------- encoder ----
def encode(cfg: ModelConfig, params, frames: torch.Tensor, *,
           engine=None, mesh=None) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend): non-causal self-attention blocks. With a ``mesh``,
    ``frames`` are this rank's rows over the data axes, and over a
    ``model`` axis the blocks compute their shard, as the decoder's do
    (their leaves are placed by the same rules); the output is whole on
    every rank of it."""
    enc = params["encoder"]
    x = frames + enc["pos"][None, : frames.shape[1]]
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)[None].expand(x.shape[0], s)
    dec_cfg = cfg.scaled(family="decoder")
    tp = tensor_parallel(cfg, mesh)
    dp = data_parallel(mesh)
    for i in range(cfg.enc_layers):
        x, _ = apply_block(dec_cfg, "g", _at(enc["blocks"], i), x, pos=pos,
                           mode="encode", engine=engine, tp=tp,
                           dp=dp)  # non-causal
    return rms_norm(x, enc["norm"], cfg.norm_eps)


# ------------------------------------------------------------- forward ----
def _unit_checkpointed(cfg: ModelConfig, unit, stacked, i: int, x, pos,
                       enc_out, mode: str, engine, tp=None, dp=None):
    """Unit ``i`` of the stacked loop under activation checkpointing: its
    parameter views are the checkpoint's inputs, so their gradients flow
    into the stacked leaves."""
    from torch.utils.checkpoint import checkpoint
    leaves, treedef = tree_flatten([_at(s, i) for s in stacked])

    def run(h, *flat):
        blks = treedef.unflatten(flat)
        for j, kind in enumerate(unit):
            h, _ = apply_block(cfg, kind, blks[j], h, pos=pos,
                               enc_out=enc_out, mode=mode, engine=engine,
                               tp=tp, dp=dp)
        return h
    # No draw in the forward needs replaying: skip saving the RNG state.
    return checkpoint(run, x, *leaves, use_reentrant=False,
                      preserve_rng_state=False)


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor,
           tp=None) -> torch.Tensor:
    scale = cfg.d_model ** 0.5 if cfg.family != "rwkv" else 1.0
    emb = params["embed"]
    if tp is None or emb.shape[0] == cfg.vocab_size:
        return emb[tokens.long()] * scale
    # vocab-parallel: this rank's rows, zero elsewhere, summed over ranks
    n = emb.shape[0]
    ids = tokens.long() - tp.index * n
    mine = (ids >= 0) & (ids < n)
    local = torch.where(mine[..., None], emb[ids.clamp(0, n - 1)], 0.0)
    return dist.reduce_from_parallel(local, tp.group) * scale


def _patches(cfg: ModelConfig, params, extra_embed: torch.Tensor, tp=None):
    """The VLM's patch embeddings through ``patch_proj``: under ``tp``
    (its columns split) a column-parallel product gathered whole, so the
    prepended patches are (B, P, D) on every rank."""
    proj = params["patch_proj"]
    if tp is None or proj.shape[-1] == cfg.d_model:
        return extra_embed @ proj
    part = dist.copy_to_parallel(extra_embed, tp.group) @ proj
    return dist.gather_out_of_parallel(part, tp.group, -1)


def _head(cfg: ModelConfig, params, x, engine, tp=None, dp=None):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    if tp is not None and head.shape[-1] != cfg.vocab_size:
        x = dist.copy_to_parallel(x, tp.group)   # logits over this shard
    return softcap(head_matmul(cfg, x, head, engine=engine, dp=dp),
                   cfg.softcap_final)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, DictKey):
            return str(entry.key)
    return ""


def _whole_lengths(stacked, n_units: int, dp):
    """The stacked decode states ``stacked`` (a list, one tree a unit
    slot) with every ``length`` leaf whole, and a function that writes
    the lengths back. ``state_shardings`` splits a stacked ``length``
    (one counter a unit) over the data axes when they divide the
    units: this rank holds its part, and the whole is gathered for the
    loop over units (GSPMD reads it so), then this rank's part of the
    new lengths is written back into its shard."""
    if dp is None or stacked is None:
        return stacked, lambda: None
    shards = []

    def whole(path, x):
        if _leaf_name(path) != "length" or x.shape[0] == n_units:
            return x
        shards.append((x, dist.all_gather(x, dp.group, dim=0)))
        return shards[-1][1]
    work = tree_map_with_path(whole, stacked)

    def back():
        for x, w in shards:
            n = x.shape[0]
            x.copy_(w[dp.index * n:(dp.index + 1) * n])
    return work, back


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            extra_embed: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            states=None, mode: str = "full",
            positions: Optional[torch.Tensor] = None,
            remat: bool = False, engine=None, mesh=None):
    """Full-sequence forward. ``tokens`` (B, S) integers.

    ``extra_embed``: (B, P, D) patch/frame embeddings prepended to the
    token stream (VLM stub frontend). With ``states`` (prefill), every
    block's new state is written into them in place. Returns
    (logits, new_states), new_states ``None`` without ``states``.

    ``remat`` (the training loss's forward, without ``states``): each
    unit of the stacked loop runs under
    ``torch.utils.checkpoint.checkpoint``, the counterpart of the
    reference's ``jax.checkpoint`` on its scan step, so backward keeps
    only each unit's input and recomputes the rest; prefix and suffix
    blocks are not rematerialised, as in the reference. The gradients do
    not change, only the peak memory.

    Given a ``mesh`` of ranks, ``params`` and ``states`` are this rank's
    shards, the inputs its rows, and over a ``model`` axis the logits
    this rank's part of the vocabulary (see the module docstring).
    """
    tp = tensor_parallel(cfg, mesh)
    dp = data_parallel(mesh)
    b, s = tokens.shape
    x = _embed(cfg, params, tokens, tp)
    if extra_embed is not None:
        x = torch.cat([_patches(cfg, params, extra_embed, tp), x], dim=1)
        s = x.shape[1]
    if positions is None:
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
    else:
        pos = positions
    enc_out = None
    if cfg.family == "encdec" and enc_frames is not None:
        enc_out = encode(cfg, params, enc_frames, engine=engine, mesh=mesh)

    prefix, unit, n_units, suffix = stack_plan(cfg)
    st = states if states is not None else {}
    new_states: Dict[str, Any] = {"prefix": [], "scan": None, "suffix": []}
    kw = dict(pos=pos, enc_out=enc_out, mode=mode, engine=engine, tp=tp,
              dp=dp)

    for i, kind in enumerate(prefix):
        x, ns = apply_block(cfg, kind, params["prefix"][i], x,
                            state=(st.get("prefix") or [None] * len(prefix))[i],
                            **kw)
        new_states["prefix"].append(ns)

    scan_states = st.get("scan")
    work, lengths_back = _whole_lengths(scan_states, n_units, dp)
    for i in range(n_units):
        if remat and scan_states is None:
            x = _unit_checkpointed(cfg, unit, params["scan"], i, x, pos,
                                   enc_out, mode, engine, tp, dp)
            continue
        for j, kind in enumerate(unit):
            x, ns = apply_block(cfg, kind, _at(params["scan"][j], i), x,
                                state=None if work is None
                                else _at(work[j], i), **kw)
            if work is not None:
                _put(work[j], i, ns)
    lengths_back()
    new_states["scan"] = scan_states

    for i, kind in enumerate(suffix):
        x, ns = apply_block(cfg, kind, params["suffix"][i], x,
                            state=(st.get("suffix") or [None] * len(suffix))[i],
                            **kw)
        new_states["suffix"].append(ns)

    logits = _head(cfg, params, x, engine, tp, dp)
    return logits, (new_states if states is not None else None)


# -------------------------------------------------------------- decode ----
def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=torch.float32, device=None,
                      mesh=None) -> Dict[str, Any]:
    """Zero decode states for every block, stacked as the parameters are,
    on ``device``. With a ``mesh`` of ranks, this rank's shard of each
    leaf as ``state_shardings`` places it (shapes from ``shard_shape``;
    nothing whole is made); a KV cache that the rules keep whole over a
    model axis carries the no-leaf key
    :data:`~repro_torch.models.blocks.WHOLE_CACHE`, since its shape alone
    does not tell it from a slice of the slots."""
    if getattr(mesh, "comm", None) is not None:
        return _sharded_decode_state(cfg, batch, cache_len, dtype, device,
                                     mesh)
    prefix, unit, n_units, suffix = stack_plan(cfg)

    def one(kind):
        return init_state(cfg, kind, batch, cache_len, dtype, device=device)

    return {
        "prefix": [one(k) for k in prefix],
        "scan": [_stack(lambda: one(k), n_units) for k in unit]
        if n_units else None,
        "suffix": [one(k) for k in suffix],
        "enc_out": (torch.zeros((batch, cfg.enc_frames, cfg.d_model),
                                dtype=dtype, device=device)
                    if cfg.family == "encdec" else None),
    }


def _sharded_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                          dtype, device, mesh) -> Dict[str, Any]:
    from repro_torch.train.sharding import (shard_shape, spec_leaves,
                                            state_shardings)
    whole = init_decode_state(cfg, batch, cache_len, dtype, device="meta")
    leaves, treedef = tree_flatten(whole)
    specs = spec_leaves(state_shardings(mesh, whole), len(leaves))
    out = [torch.zeros(shard_shape(mesh, tuple(x.shape), spec),
                       dtype=x.dtype, device=device)
           for x, spec in zip(leaves, specs)]
    states = treedef.unflatten(out)
    if tensor_parallel(cfg, mesh) is None:
        return states
    whole_kv = {id(x) for (path, x), spec in zip(
        tree_flatten_with_path(states)[0], specs)
        if _leaf_name(path) == "k" and "model" not in spec}

    def mark(tree):         # a cache the model axis keeps whole
        if isinstance(tree, dict):
            tree = {k: mark(v) for k, v in tree.items()}
            if "k" in tree and id(tree["k"]) in whole_kv:
                tree[WHOLE_CACHE] = None
        elif isinstance(tree, list):
            tree = [mark(v) for v in tree]
        return tree
    return mark(states)


def decode_step(cfg: ModelConfig, params, token: torch.Tensor,
                position: torch.Tensor, states: Dict[str, Any], *,
                engine=None, mesh=None):
    """One-token serve step. token (B,1); position (B,1) absolute.

    The stacked states are updated in place (the reference carries them
    through its scan and updates them with ``dynamic_update_index``);
    the returned tree holds the same stacked buffers. With a ``mesh`` of
    ranks, ``token``, ``position`` and ``states`` are this rank's rows
    and shards, and over ``model`` the logits this rank's part of the
    vocabulary (see the module docstring)."""
    tp = tensor_parallel(cfg, mesh)
    dp = data_parallel(mesh)
    x = _embed(cfg, params, token, tp)
    enc_out = states.get("enc_out")
    prefix, unit, n_units, suffix = stack_plan(cfg)
    new_states = dict(states)
    new_states["prefix"] = []
    new_states["suffix"] = []
    kw = dict(pos=position, enc_out=enc_out, mode="decode", engine=engine,
              tp=tp, dp=dp)

    for i, kind in enumerate(prefix):
        x, ns = apply_block(cfg, kind, params["prefix"][i], x,
                            state=states["prefix"][i], **kw)
        new_states["prefix"].append(ns)

    work, lengths_back = _whole_lengths(states["scan"], n_units, dp)
    for i in range(n_units):
        for j, kind in enumerate(unit):
            x, ns = apply_block(cfg, kind, _at(params["scan"][j], i), x,
                                state=_at(work[j], i), **kw)
            _put(work[j], i, ns)
    lengths_back()

    for i, kind in enumerate(suffix):
        x, ns = apply_block(cfg, kind, params["suffix"][i], x,
                            state=states["suffix"][i], **kw)
        new_states["suffix"].append(ns)

    return _head(cfg, params, x, engine, tp, dp), new_states

