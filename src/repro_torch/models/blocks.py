"""Transformer-family blocks: init + apply for each layer kind.

The port's copy of ``repro.models.blocks``, in plain torch. Every block
is a pair of functions:

* ``init_<kind>(cfg, ini) -> params`` (dict tree)
* ``apply_<kind>(cfg, params, x, *, pos, state, enc_out, mode, engine)
  -> (y, new_state)``

``mode`` is ``"full"`` (prefill over a whole sequence), ``"encode"``
(non-causal encoder) or ``"decode"`` (one token, stateful). ``state`` is
kind-specific:

* attention ('g'/'l'): ``{"self": {"k", "v", "length"}}``, the fields of
  :class:`repro_torch.models.attention.KVCache`
* RG-LRU ('r', hybrid): {"h": (B, D), "conv": (B, 3, D)}
* RWKV-6 ('r', rwkv): {"wkv": (B, H, dh, dh), "tshift"/"cshift": (B, D)}
* MoE ('m'/'d'): same as attention (the FFN is stateless).

``engine`` is the :class:`repro_torch.engine.Engine` that the projections
of the PIM scopes (``cfg.pim_scopes()``) run through; projections outside
them are plain ``@``. MoE dispatch is dropless sort -> grouped GEMM ->
scatter-add, so prefill and decode agree.

``tp`` (:func:`tensor_parallel`) is this rank's place on the mesh's
``model`` axis, or None. Under it every block kind computes its shard in
Megatron's layout, which is what GSPMD makes of the partition rules
(``repro_torch.train.sharding``), with the collectives written out
(:mod:`repro_torch.dist`):

* attention (self and cross): q/k/v column-parallel on this rank's
  heads, the out-projection row-parallel, then the sum over ranks; the
  decode state is this rank's shard of the KV cache as
  ``state_shardings`` places it: its KV heads, or, where the KV heads do
  not split over the axis, its slots of the sequence for every KV head
  (the new entries of the heads other ranks compute are gathered, and
  attention combines the ranks' partial softmaxes,
  :func:`repro_torch.models.attention.decode_attend_split`);
* the MLPs: w1/w3 column-parallel, w2 row-parallel, at the block's own
  width (a dense block inside a MoE stack, the shared experts);
* MoE: expert parallelism. Every rank routes every token with the whole
  router and computes the routed pairs of its experts; the gated
  outputs are summed over the ranks;
* RG-LRU: channel-parallel (the in-projections column-parallel, the
  conv, gates and scan on this rank's channels, ``wo`` row-parallel);
* RWKV-6: head-parallel time mix (its group-norm proxy's mean square
  summed over the ranks) and a channel mix with ``ck`` column- and
  ``cv`` row-parallel; the token-shift states are this rank's channels,
  gathered whole each step.

A replicated leaf used inside a parallel region passes through
``copy_to_parallel``, so its gradient is summed over the ranks. A leaf
that the rules keep whole because its dimension does not divide the
axis is used whole: a ``d_ff`` that does not split runs the whole MLP on
every rank, experts that do not split all run on every rank, and neither
is summed.

Where the axis cannot split a block's heads (:func:`heads_split`: query
heads it does not divide, or that do not align with the KV groups, or
RWKV heads it does not divide), every rank runs that block's attention
(self and cross) or RWKV time mix over all heads, as one rank would,
and its output needs no sum. The leaves stay placed by the rules: a
whole one is used as it is, a split one (its shard may cut a head) is
gathered whole, and backward each rank keeps its own slice of the
gradient, which every rank computes whole and alike (:func:`_whole`).
The block's MLP still splits where its width divides. A decode cache is
placed by ``state_shardings`` as ever: over the slots, every rank
attending its own and the partial softmaxes combined, or whole on every
rank.

``dp`` is this rank's place on the data axes (``pod``, ``data``), over
which the rows of ``x`` are split, or None. Only the PIM projections
read it: a quantisation scale is the whole tensor's, so each projection
takes its amax over ``dp`` (and, row-parallel, over ``tp``), as the
reference quantises its global arrays (:func:`pim_proj`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.pim.quant import ragged_dot

from .attention import (KVCache, attend, decode_attend,
                        decode_attend_split)
from .layers import Initializer, rms_norm, rope

__all__ = ["init_block", "apply_block", "init_state", "pim_proj",
           "tensor_parallel", "data_parallel", "heads_split", "WHOLE_CACHE"]

# A key with no leaf (its value None) in a KV cache's state: the cache is
# whole on every rank of the model axis (``state_shardings`` splits it
# over neither its KV heads nor its slots), which a rank's shard alone
# cannot tell from a slice of the slots.
WHOLE_CACHE = "whole"


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def _engine(engine):
    if engine is None:
        from repro_torch.engine import get_engine   # the card's engine
        engine = get_engine()
    return engine


# ------------------------------------------------- tensor parallelism ----
def tensor_parallel(cfg: ModelConfig, mesh):
    """This rank's :class:`repro_torch.dist.ParallelAxis` on the
    ``model`` axis of ``mesh``, or None when there is no mesh of ranks
    or that axis holds one rank. Every config takes any axis: where it
    cannot split a block's heads the block runs them whole
    (:func:`heads_split`)."""
    if mesh is None or getattr(mesh, "comm", None) is None:
        return None
    tp = dist.mesh_axis(mesh, ("model",))
    return None if tp.size == 1 else tp


def heads_split(cfg: ModelConfig, tp) -> bool:
    """Whether a block's heads split over ``tp`` (Megatron's layout: each
    rank its heads' columns), or run whole on every rank (False, also
    without a model axis): query heads that the axis divides into runs
    aligned with the KV groups, or RWKV heads (``d_model /
    rwkv_head_dim``) that it divides."""
    if tp is None:
        return False
    if cfg.family == "rwkv":
        return (cfg.d_model // cfg.rwkv_head_dim) % tp.size == 0
    if cfg.n_heads % tp.size:
        return False
    hq, g = cfg.n_heads // tp.size, cfg.n_heads // cfg.n_kv_heads
    return hq % g == 0 or g % hq == 0


def data_parallel(mesh):
    """This rank's :class:`repro_torch.dist.ParallelAxis` on the data axes
    (``pod``, ``data``) of ``mesh``, or None when they hold one rank (or
    there is no mesh of ranks)."""
    dp = dist.mesh_axis(mesh, ("pod", "data"))
    return dp if dp.group is not None else None


def _group(axis):
    return None if axis is None else axis.group


def _tp_range(full: int, tp):
    """This rank's ``[lo, hi)`` of a dimension of ``full`` that the rules
    split over ``tp``, or None when it does not divide (its leaves stay
    whole) or there is no model axis."""
    if tp is None or full % tp.size:
        return None
    n = full // tp.size
    return tp.index * n, (tp.index + 1) * n


def _tp_cols(w: torch.Tensor, lo: int, hi: int, full: int, tp,
             dim: int = -1) -> torch.Tensor:
    """Columns (``dim``) ``[lo, hi)`` of the whole weight, from this
    rank's stored ``w`` for use in a parallel region: its own shard when
    that holds them; the whole leaf gathered (a reduce-scatter of its
    gradient) when it does not, as GSPMD reshards a shard that splits a
    head; a replicated leaf with its gradient summed over the ranks."""
    dim = dim % w.ndim
    n = w.shape[dim]
    if n == full:
        return dist.copy_to_parallel(w, tp.group).narrow(dim, lo, hi - lo)
    start = tp.index * n
    if start <= lo and hi <= start + n:
        return w.narrow(dim, lo - start, hi - lo)
    whole = dist.gather_from_parallel(w, tp.group, dim)
    return whole.narrow(dim, lo, hi - lo)


def _whole(w: torch.Tensor, full: int, tp, dim: int = -1) -> torch.Tensor:
    """The whole leaf for a block that every rank of ``tp`` runs alike
    (heads that do not split): ``w`` as stored where the rules keep its
    ``full`` columns (``dim``) whole, else its shards gathered. Its
    gradient is the whole one on every rank alike, so it is not summed,
    and a shard keeps its own slice of it."""
    if tp is None or w.shape[dim] == full:
        return w
    return dist.gather_out_of_parallel(w, tp.group, dim)


# ------------------------------------------------------ PIM offload ----
def pim_proj(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor, *,
             scope: str, engine=None, dp=None, tp=None) -> torch.Tensor:
    """One block linear, optionally offloaded to the PIM engine.

    ``scope`` is ``"attn"`` (q/k/v/o projections) or ``"ffn"`` (both
    FFN projections); whether it routes through ``engine`` (default
    :func:`repro_torch.engine.get_engine`, on the card) is governed by
    ``cfg.pim_block_mode`` (:meth:`ModelConfig.pim_scopes`). The engine
    path quantizes to ``cfg.pim_linear_bits``, takes the integer matmul
    bit-identical to the in-memory MultPIM-MAC, and compiles the
    co-scheduled MAC group into the shared program cache once: every
    projection of every layer reuses the one verified schedule.

    On a mesh: ``dp`` is this rank's place on the data axes, over which
    ``x``'s rows are split; ``tp``, given for a row-parallel projection,
    its place on the model axis, over which ``x``'s last dimension and
    ``w``'s first are split. The result is then the sum over ``tp``'s
    ranks. On the PIM path the scales are the whole tensors' and the
    integer product is summed before it is dequantised
    (:meth:`repro_torch.engine.Engine.linear`), so the projection equals
    the unsplit one bit for bit, given the same inputs.
    """
    if scope not in cfg.pim_scopes():
        return dist.reduce_from_parallel(x @ w, _group(tp))
    mode = "pim" if cfg.pim_linear_mode == "off" else cfg.pim_linear_mode
    return _engine(engine).linear(x, w, n_bits=cfg.pim_linear_bits,
                                  mode=mode, x_group=_group(dp),
                                  k_group=_group(tp))


def _pim_ragged(cfg: ModelConfig, xs: torch.Tensor, we: torch.Tensor,
                counts, *, engine=None, dp=None, ep=None) -> torch.Tensor:
    """MoE per-expert grouped GEMM, PIM-offloaded under the ``"ffn"``
    scope (the expert FFNs are the block's FFN projections). ``xs``'s
    scale is the maximum over ``dp``; under expert parallelism (``ep``,
    the model axis that splits the experts) both scales are also the
    maxima over its ranks: the whole stack's and every routed row's."""
    if "ffn" not in cfg.pim_scopes():
        return ragged_dot(xs, we, counts)
    mode = "pim" if cfg.pim_linear_mode == "off" else cfg.pim_linear_mode
    return _engine(engine).ragged_linear(xs, we, counts,
                                         n_bits=cfg.pim_linear_bits,
                                         mode=mode, x_group=_group(dp),
                                         k_group=_group(ep))


# ============================================================ attention ====
def _init_attn_core(cfg: ModelConfig, ini: Initializer) -> Dict[str, Any]:
    d = cfg.d_model
    p = {
        "wq": ini(d, cfg.q_dim, scale=d ** -0.5),
        "wk": ini(d, cfg.kv_dim, scale=d ** -0.5),
        "wv": ini(d, cfg.kv_dim, scale=d ** -0.5),
        "wo": ini(cfg.q_dim, d, scale=(cfg.q_dim * 2 * cfg.n_layers) ** -0.5),
    }
    if cfg.qk_norm:
        p["qn"] = ini.zeros(cfg.hd)
        p["kn"] = ini.zeros(cfg.hd)
    return p


def _init_mlp(cfg: ModelConfig, ini: Initializer, d_ff: int) -> Dict[str, Any]:
    d = cfg.d_model
    p = {"w1": ini(d, d_ff, scale=d ** -0.5),
         "w2": ini(d_ff, d, scale=(d_ff * 2 * cfg.n_layers) ** -0.5)}
    if cfg.mlp_type == "swiglu":
        p["w3"] = ini(d, d_ff, scale=d ** -0.5)
    return p


def _apply_mlp(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor, *,
               d_ff: int, engine=None, tp=None, dp=None):
    # Same math as layers.swiglu/gelu_mlp, with each projection routed
    # through the PIM hook (plain matmul when the scope is off). ``d_ff``
    # is this MLP's whole width (the block's, which ``_init_mlp`` drew):
    # a shard's leaves do not tell it.
    if tp is not None and d_ff % tp.size == 0:
        return _apply_mlp_tp(cfg, p, x, d_ff, tp, engine, dp)
    kw = dict(scope="ffn", engine=engine, dp=dp)
    h1 = pim_proj(cfg, x, p["w1"], **kw)
    if "w3" in p:
        gated = F.silu(h1) * pim_proj(cfg, x, p["w3"], **kw)
        return pim_proj(cfg, gated, p["w2"], **kw)
    return pim_proj(cfg, _gelu(h1), p["w2"], **kw)


def _apply_mlp_tp(cfg: ModelConfig, p, x, d_ff: int, tp, engine, dp):
    """The MLP on this rank's ``d_ff / tp`` columns: ``w1``/``w3``
    column-parallel, ``w2`` row-parallel, then the sum over ranks. (A
    ``d_ff`` that does not split keeps every weight whole, and every
    rank computes the whole MLP.)"""
    lo, hi = _tp_range(d_ff, tp)
    kw = dict(scope="ffn", engine=engine, dp=dp)
    xp = dist.copy_to_parallel(x, tp.group)
    h1 = pim_proj(cfg, xp, _tp_cols(p["w1"], lo, hi, d_ff, tp), **kw)
    if "w3" in p:
        h = F.silu(h1) * pim_proj(
            cfg, xp, _tp_cols(p["w3"], lo, hi, d_ff, tp), **kw)
    else:
        h = _gelu(h1)
    return pim_proj(cfg, h, _tp_cols(p["w2"], lo, hi, d_ff, tp, dim=-2),
                    tp=tp, **kw)


def init_attn_block(cfg: ModelConfig, ini: Initializer, kind: str,
                    d_ff: Optional[int] = None) -> Dict[str, Any]:
    """Parameters of one attention block (+ cross-attention for enc-dec)."""
    p = {"ln1": ini.zeros(cfg.d_model), "ln2": ini.zeros(cfg.d_model)}
    p.update(_init_attn_core(cfg, ini))
    p["mlp"] = _init_mlp(cfg, ini, d_ff or cfg.d_ff)
    if cfg.family == "encdec":
        d = cfg.d_model
        p["lnx"] = ini.zeros(d)
        p["xq"] = ini(d, cfg.q_dim, scale=d ** -0.5)
        p["xk"] = ini(d, cfg.kv_dim, scale=d ** -0.5)
        p["xv"] = ini(d, cfg.kv_dim, scale=d ** -0.5)
        p["xo"] = ini(cfg.q_dim, d, scale=(cfg.q_dim * 2 * cfg.n_layers) ** -0.5)
    return p


def _tp_heads(cfg: ModelConfig, tp):
    """(first query head, query heads, first KV head, KV heads) of this
    rank: its ``n_heads / tp`` query heads and the KV heads they map to
    under GQA."""
    hq = cfg.n_heads // tp.size
    q0 = tp.index * hq
    g = cfg.n_heads // cfg.n_kv_heads
    k0, k1 = q0 // g, (q0 + hq - 1) // g + 1
    return q0, hq, k0, k1 - k0


def _heads_tp(cfg: ModelConfig, xp, w, h0: int, nh: int, full: int, tp,
             **kw) -> torch.Tensor:
    """``xp`` (B, S, D) through heads ``[h0, h0 + nh)`` of the
    column-parallel ``w`` (``full`` columns whole): (B, S, nh, hd)."""
    b, s, _ = xp.shape
    hd = cfg.hd
    return pim_proj(cfg, xp, _tp_cols(w, h0 * hd, (h0 + nh) * hd, full, tp),
                    **kw).reshape(b, s, nh, hd)


def _out_tp(cfg: ModelConfig, o, w, tp, *, pim: bool = True, **kw):
    """The row-parallel out-projection of ``o`` (B, S, hq, hd), this
    rank's query heads, through ``w`` (``q_dim`` rows whole), summed over
    the ranks: through :func:`pim_proj`, or (``pim=False``) a plain
    ``@``, as the reference takes the MoE block's."""
    b, s, hq, hd = o.shape
    q0 = _tp_heads(cfg, tp)[0]
    w = _tp_cols(w, q0 * hd, (q0 + hq) * hd, cfg.q_dim, tp, dim=-2)
    o = o.reshape(b, s, hq * hd)
    if not pim:
        return dist.reduce_from_parallel(o @ w, tp.group)
    return pim_proj(cfg, o, w, tp=tp, **kw)


def _qkv_tp(cfg: ModelConfig, p, xn, pos, tp, engine, dp):
    """q, k, v of this rank's heads (column-parallel projections)."""
    q0, hq, k0, hk = _tp_heads(cfg, tp)
    kw = dict(scope="attn", engine=engine, dp=dp)
    xp = dist.copy_to_parallel(xn, tp.group)
    q = _heads_tp(cfg, xp, p["wq"], q0, hq, cfg.q_dim, tp, **kw)
    k = _heads_tp(cfg, xp, p["wk"], k0, hk, cfg.kv_dim, tp, **kw)
    v = _heads_tp(cfg, xp, p["wv"], k0, hk, cfg.kv_dim, tp, **kw)
    if cfg.qk_norm:
        q = rms_norm(q, dist.copy_to_parallel(p["qn"], tp.group),
                     cfg.norm_eps)
        k = rms_norm(k, dist.copy_to_parallel(p["kn"], tp.group),
                     cfg.norm_eps)
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def _qkv(cfg: ModelConfig, p, xn, pos, engine, tp=None, dp=None):
    """q, k, v: of this rank's heads where they split over ``tp``, else
    of every head (the leaves made whole, :func:`_whole`)."""
    if heads_split(cfg, tp):
        return _qkv_tp(cfg, p, xn, pos, tp, engine, dp)
    b, s, _ = xn.shape
    kw = dict(scope="attn", engine=engine, dp=dp)
    q = pim_proj(cfg, xn, _whole(p["wq"], cfg.q_dim, tp), **kw).reshape(
        b, s, cfg.n_heads, cfg.hd)
    k = pim_proj(cfg, xn, _whole(p["wk"], cfg.kv_dim, tp), **kw).reshape(
        b, s, cfg.n_kv_heads, cfg.hd)
    v = pim_proj(cfg, xn, _whole(p["wv"], cfg.kv_dim, tp), **kw).reshape(
        b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def _pad_seq(x, n):
    """Pad (B, S, H, D) with ``n`` zero rows at the end of S."""
    return F.pad(x, (0, 0, 0, 0, 0, n))


def _seq_split(cfg: ModelConfig, tp, cache_k: torch.Tensor):
    """``tp`` when this rank's cache shard ``cache_k`` (B, T_l, H_l, D)
    holds a slice of the sequence (``state_shardings``' branch for KV
    heads that do not split over the model axis: every KV head), None
    when it holds a slice of the KV heads or there is no model axis.
    Raises when the shard holds other KV heads than this rank computes
    (:func:`_tp_heads`), or a slice of the sequence without every
    head."""
    if tp is None:
        return None
    hl = cache_k.shape[-2]
    if cfg.n_kv_heads % tp.size:
        if hl != cfg.n_kv_heads:
            raise ValueError(f"{cfg.name}: a cache shard split over the "
                             f"sequence holds {hl} of {cfg.n_kv_heads} KV "
                             f"heads")
        return tp
    mine = _tp_heads(cfg, tp)[2:]
    if mine != (tp.index * hl, hl):
        raise ValueError(f"{cfg.name}: rank {tp.index} of {tp.size} computes "
                         f"KV heads [{mine[0]}, {sum(mine)}), its cache "
                         f"shard holds [{tp.index * hl}, "
                         f"{(tp.index + 1) * hl})")
    return None


def _every_kv_head(cfg: ModelConfig, k, v, tp):
    """``k``/``v`` (B, S, hk, D) of this rank's KV heads made whole over
    the heads, for a cache split over the sequence: a rank computes only
    the KV heads of its query heads, so where those are fewer than every
    head (several ranks share one KV group) the ranks' heads are
    gathered and the first rank that computes a head gives it."""
    hk = k.shape[2]
    if hk == cfg.n_kv_heads:
        return k, v
    kv = dist.all_gather(torch.cat([k, v], dim=-1), tp.group, dim=2)
    g = cfg.n_heads // cfg.n_kv_heads
    hq = cfg.n_heads // tp.size
    first = {}
    for r in range(tp.size):           # rank r computes heads k0, k0 + hk
        k0 = r * hq // g
        for j in range(hk):
            first.setdefault(k0 + j, r * hk + j)
    idx = torch.tensor([first[h] for h in range(cfg.n_kv_heads)],
                       device=k.device)
    kv = kv.index_select(2, idx)
    d = k.shape[-1]
    return kv[..., :d], kv[..., d:]


def _decode_whole_cache(cfg: ModelConfig, q, cache: KVCache, k, v, tp, *,
                        window, cap):
    """A decode step of this rank's query heads ``q`` over a cache whole
    on every rank (every KV head) while the heads split over ``tp``: the
    new key and value of every head (gathered) go into every rank's
    cache, and the rank attends over its own KV heads' slice of it."""
    k0, hk = _tp_heads(cfg, tp)[2:]
    ka, va = _every_kv_head(cfg, k, v, tp)
    mine = KVCache(cache.k.narrow(2, k0, hk), cache.v.narrow(2, k0, hk),
                   cache.length)
    o, mine = decode_attend(q, mine, k, v, window=window, cap=cap)
    slot = torch.remainder(cache.length, cache.k.shape[1]).reshape(1).to(
        torch.int64)
    cache.k.index_copy_(1, slot, ka.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, va.to(cache.v.dtype))
    return o, KVCache(cache.k, cache.v, mine.length)


def _prefill_cache(cache, k, v, split):
    """The KV cache a prefill of ``k``/``v`` (B, S, H, D) leaves in the
    cache ``cache`` (``{"k", "v", "length"}``; with ``split``, this
    rank's slots of a sequence split over ``split``'s ranks): the prompt
    padded to the cache, or, past a window's T slots, its last T tokens
    rotated so token j sits at ring slot j % T."""
    t_l = cache["k"].shape[1]
    t = t_l * (split.size if split is not None else 1)
    s = k.shape[1]
    kc, vc = k, v
    if s < t:
        kc, vc = _pad_seq(k, t - s), _pad_seq(v, t - s)
    elif s > t:
        kc = torch.roll(k[:, -t:], s % t, dims=1)
        vc = torch.roll(v[:, -t:], s % t, dims=1)
    if split is not None:
        kc = kc.narrow(1, split.index * t_l, t_l)
        vc = vc.narrow(1, split.index * t_l, t_l)
    return {"k": kc.to(cache["k"].dtype), "v": vc.to(cache["v"].dtype),
            "length": torch.tensor(s, dtype=torch.int32, device=k.device)}


def _self_attend(cfg: ModelConfig, q, k, v, state, mode: str, tp, *,
                 window=None, fill: bool = True):
    """Self-attention of ``q``/``k``/``v`` (this rank's heads where they
    split over ``tp``) and the state it leaves: with ``state``, a
    prefill writes the KV behind (``fill``; the reference's MoE block
    does not), a decode step appends to this rank's shard of the cache:
    its KV heads, its slots of every head, or the whole cache
    (:data:`WHOLE_CACHE`), which every rank keeps alike."""
    cache = None if state is None else state["self"]
    whole = tp is not None and cache is not None and WHOLE_CACHE in cache
    split = None if cache is None or whole else _seq_split(cfg, tp,
                                                           cache["k"])
    new_state = state
    if mode in ("full", "encode"):
        o = attend(q, k, v, causal=(mode != "encode"), window=window,
                   cap=cfg.softcap_attn)
        if state is not None and fill:     # prefill: leave the KV behind
            if split is not None or whole:
                k, v = _every_kv_head(cfg, k, v, tp)
            new_state = dict(state)
            new_state["self"] = _marked(_prefill_cache(cache, k, v, split),
                                        whole)
    else:
        kv = KVCache(cache["k"], cache["v"], cache["length"])
        if whole and k.shape[2] != cfg.n_kv_heads:
            o, kv = _decode_whole_cache(cfg, q, kv, k, v, tp, window=window,
                                        cap=cfg.softcap_attn)
        elif split is None:
            o, kv = decode_attend(q, kv, k, v, window=window,
                                  cap=cfg.softcap_attn)
        else:
            k, v = _every_kv_head(cfg, k, v, split)
            o, kv = decode_attend_split(
                q, kv, k, v, split.group, split.index, split.size,
                window=window, cap=cfg.softcap_attn,
                every_head=not heads_split(cfg, split))
        new_state = dict(state)
        new_state["self"] = _marked(kv._asdict(), whole)
    return o, new_state


def _marked(cache: Dict[str, Any], whole: bool) -> Dict[str, Any]:
    """``cache`` with the :data:`WHOLE_CACHE` mark where ``whole``."""
    return {**cache, WHOLE_CACHE: None} if whole else cache


def _cross_attend(cfg: ModelConfig, p, xn, enc_out, tp, attn):
    """Enc-dec cross-attention of ``xn`` over the encoder's ``enc_out``
    (whole on every rank; where the heads split over ``tp``,
    ``xq``/``xk``/``xv`` column-parallel on this rank's heads and ``xo``
    row-parallel)."""
    b, s, _ = xn.shape
    f = enc_out.shape[1]
    if not heads_split(cfg, tp):        # every head (leaves made whole)
        qx = pim_proj(cfg, xn, _whole(p["xq"], cfg.q_dim, tp),
                      **attn).reshape(b, s, cfg.n_heads, cfg.hd)
        kx = pim_proj(cfg, enc_out, _whole(p["xk"], cfg.kv_dim, tp),
                      **attn).reshape(b, f, cfg.n_kv_heads, cfg.hd)
        vx = pim_proj(cfg, enc_out, _whole(p["xv"], cfg.kv_dim, tp),
                      **attn).reshape(b, f, cfg.n_kv_heads, cfg.hd)
        ox = attend(qx, kx, vx, causal=False)
        return pim_proj(cfg, ox.reshape(b, s, cfg.q_dim),
                        _whole(p["xo"], cfg.q_dim, tp, dim=-2), **attn)
    q0, hq, k0, hk = _tp_heads(cfg, tp)
    xp = dist.copy_to_parallel(xn, tp.group)
    ep = dist.copy_to_parallel(enc_out, tp.group)
    qx = _heads_tp(cfg, xp, p["xq"], q0, hq, cfg.q_dim, tp, **attn)
    kx = _heads_tp(cfg, ep, p["xk"], k0, hk, cfg.kv_dim, tp, **attn)
    vx = _heads_tp(cfg, ep, p["xv"], k0, hk, cfg.kv_dim, tp, **attn)
    return _out_tp(cfg, attend(qx, kx, vx, causal=False), p["xo"], tp,
                   **attn)


def apply_attn_block(cfg: ModelConfig, p, x, *, pos, state, enc_out, mode,
                     kind: str, d_ff: Optional[int] = None, engine=None,
                     tp=None, dp=None):
    """One attention block: (self-attention [+ cross-attention] + MLP).
    ``d_ff``: the MLP's width (default ``cfg.d_ff``; a dense block
    inside a MoE stack has its own). Under ``tp``, attention and the MLP
    on this rank's heads (or every head, where they do not split) and
    columns, with this rank's shard of the KV cache (see the module
    docstring)."""
    b, s, d = x.shape
    window = cfg.window if kind == "l" else None
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, xn, pos, engine, tp, dp)
    o, new_state = _self_attend(cfg, q, k, v, state, mode, tp, window=window)
    attn = dict(scope="attn", engine=engine, dp=dp)
    if heads_split(cfg, tp):    # row-parallel out-projection, then the sum
        x = x + _out_tp(cfg, o, p["wo"], tp, **attn)
    else:
        x = x + pim_proj(cfg, o.reshape(b, s, cfg.q_dim),
                         _whole(p["wo"], cfg.q_dim, tp, dim=-2), **attn)

    if cfg.family == "encdec" and enc_out is not None:
        xn2 = rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + _cross_attend(cfg, p, xn2, enc_out, tp, attn)

    xn3 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _apply_mlp(cfg, p["mlp"], xn3, d_ff=d_ff or cfg.d_ff,
                       engine=engine, tp=tp, dp=dp)
    return x, new_state


# ================================================================= MoE ====
def init_moe_block(cfg: ModelConfig, ini: Initializer) -> Dict[str, Any]:
    """Parameters of one MoE block (attention + routed/shared experts)."""
    e = cfg.moe
    d, f = cfg.d_model, cfg.d_ff
    p = {"ln1": ini.zeros(d), "ln2": ini.zeros(d)}
    p.update(_init_attn_core(cfg, ini))
    p["router"] = ini(d, e.n_experts, scale=d ** -0.5)
    p["we1"] = ini(e.n_experts, d, f, scale=d ** -0.5)
    p["we3"] = ini(e.n_experts, d, f, scale=d ** -0.5)
    p["we2"] = ini(e.n_experts, f, d, scale=(f * 2 * cfg.n_layers) ** -0.5)
    if e.n_shared:
        p["shared"] = _init_mlp(cfg, ini, f * e.n_shared)
    return p


MOE_CHUNK = 32768   # cap tokens per dispatch so the sorted dispatch
# activations stay bounded for 1M-token prefills.


def moe_ffn(cfg: ModelConfig, p, x3: torch.Tensor, *,
            engine=None, dp=None, tp=None) -> torch.Tensor:
    """Dropless top-k expert FFN over (B, S, D); long sequences are
    dispatched in chunks along S, so the sorted (T*k, D) dispatch
    activations stay O(chunk). ``tp``: see :func:`_moe_ffn_chunk`."""
    b, s, d = x3.shape
    sc = max(1, MOE_CHUNK // max(1, b))
    kw = dict(engine=engine, dp=dp, tp=tp)
    if s > sc and s % sc == 0:
        ys = [_moe_ffn_chunk(cfg, p, x3[:, c:c + sc].reshape(b * sc, d),
                             **kw).reshape(b, sc, d)
              for c in range(0, s, sc)]
        return torch.cat(ys, dim=1)
    return _moe_ffn_chunk(cfg, p, x3.reshape(b * s, d), **kw).reshape(b, s, d)


def _expert_counts(flat_e: torch.Tensor, n_experts: int):
    """Rows routed to each expert: (E,) int32 counts of ``flat_e``.

    A fake tensor (a shape-only trace, :mod:`repro_torch.launch.dryrun`)
    holds no routing to count, so the trace takes it balanced: T*k // E
    rows an expert, the remainder one each to the first experts, as a
    list (under expert parallelism the caller keeps its experts' part).
    Dropless dispatch computes every routed pair whatever the routing,
    so the FLOPs are those of any real routing; real tensors are
    counted."""
    if is_fake(flat_e):
        n, rest = divmod(flat_e.numel(), n_experts)
        return [n + (i < rest) for i in range(n_experts)]
    return torch.bincount(flat_e, minlength=n_experts).to(torch.int32)


def _moe_ffn_chunk(cfg: ModelConfig, p, x2: torch.Tensor, *,
                   engine=None, dp=None, tp=None) -> torch.Tensor:
    """Dropless dispatch: sort token-expert pairs by expert (stable), then
    grouped GEMMs over the ragged per-expert segments, then a scatter-add
    of the gated outputs back to their tokens.

    Every routed pair is computed (no capacity bound), so a token's
    output never depends on the other tokens of the dispatch and
    prefill equals token-by-token decode. The router is a plain ``@``,
    as in the reference.

    Under ``tp`` with the experts split over it (expert parallelism,
    ``we*`` this rank's ``E / tp`` experts): every rank routes every
    token with the whole router, keeps the stretch of the sorted pairs
    whose experts are its own (the sort is by expert, so they are
    contiguous), computes them, and the scatter-added outputs are summed
    over the ranks. The shared experts are an MLP of width ``d_ff *
    n_shared``, column- and row-parallel. Experts that the axis does not
    split stay whole and run on every rank.
    """
    e = cfg.moe
    t, d = x2.shape
    ep = (tp if tp is not None and p["we1"].shape[0] != e.n_experts
          else None)
    xe, router = x2, p["router"]
    if ep is not None:          # replicated, used in the parallel region
        xe = dist.copy_to_parallel(x2, ep.group)
        router = dist.copy_to_parallel(router, ep.group)
    logits = xe @ router
    gate, idx = torch.topk(logits, e.top_k, dim=-1)        # (T, k)
    gate = torch.softmax(gate.to(torch.float32), dim=-1).to(x2.dtype)

    flat_e = idx.reshape(-1)                               # (T*k,)
    flat_t = torch.arange(t, device=x2.device).repeat_interleave(e.top_k)
    order = torch.argsort(flat_e, stable=True)
    st, sg = flat_t[order], gate.reshape(-1)[order]
    counts = _expert_counts(flat_e, e.n_experts)
    if ep is not None:          # this rank's experts' stretch of the pairs
        n = p["we1"].shape[0]
        counts = counts.tolist() if torch.is_tensor(counts) else counts
        lo = sum(counts[:ep.index * n])
        counts = counts[ep.index * n:(ep.index + 1) * n]
        st, sg = st[lo:lo + sum(counts)], sg[lo:lo + sum(counts)]

    xs = xe[st]                                            # (T*k, d)
    kw = dict(engine=engine, dp=dp, ep=ep)
    h = _pim_ragged(cfg, xs, p["we1"], counts, **kw)
    h3 = _pim_ragged(cfg, xs, p["we3"], counts, **kw)
    y = _pim_ragged(cfg, F.silu(h) * h3, p["we2"], counts, **kw)
    out = torch.zeros_like(x2).index_add_(0, st, y * sg[:, None])
    if ep is not None:
        out = dist.reduce_from_parallel(out, ep.group)
    if e.n_shared:
        out = out + _apply_mlp(cfg, p["shared"], x2,
                               d_ff=cfg.d_ff * e.n_shared, engine=engine,
                               tp=tp, dp=dp)
    return out


def apply_moe_block(cfg: ModelConfig, p, x, *, pos, state, enc_out, mode,
                    engine=None, tp=None, dp=None):
    """One MoE block: self-attention (``wo`` plain; a prefill leaves no
    KV behind, as in the reference) + the expert FFN. Under ``tp``,
    attention on this rank's heads (``wo`` row-parallel, summed) and the
    experts split over the ranks (:func:`_moe_ffn_chunk`)."""
    b, s, d = x.shape
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, xn, pos, engine, tp, dp)
    o, new_state = _self_attend(cfg, q, k, v, state, mode, tp, fill=False)
    if heads_split(cfg, tp):
        x = x + _out_tp(cfg, o, p["wo"], tp, pim=False)
    else:
        x = x + (o.reshape(b, s, cfg.q_dim)
                 @ _whole(p["wo"], cfg.q_dim, tp, dim=-2))
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + moe_ffn(cfg, p, xn2, engine=engine, dp=dp, tp=tp), new_state


# ============================================================== RG-LRU ====
def init_rglru_block(cfg: ModelConfig, ini: Initializer) -> Dict[str, Any]:
    """Parameters of one RG-LRU (recurrentgemma) block."""
    d = cfg.d_model
    p = {
        "ln1": ini.zeros(d), "ln2": ini.zeros(d),
        "wx": ini(d, d, scale=d ** -0.5),     # recurrence branch in-proj
        "wg": ini(d, d, scale=d ** -0.5),     # gelu gate branch
        "wo": ini(d, d, scale=(d * 2 * cfg.n_layers) ** -0.5),
        "conv": ini(4, d, scale=0.1),         # causal depthwise conv
        "wa": ini(d, d, scale=d ** -0.5),     # recurrence gate r_t
        "wi": ini(d, d, scale=d ** -0.5),     # input gate i_t
        "lam": ini.zeros(d) + 2.0,            # sigmoid(lam)^c decay base
    }
    p["mlp"] = _init_mlp(cfg, ini, cfg.d_ff)
    return p


def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t over axis 1, one step at a time.

    The reference takes this as a log-depth ``associative_scan``; the
    sums associate differently, so the two agree to float32 rounding
    (about 1e-6 relative), not bit for bit.
    """
    h = h0
    hs = []
    for i in range(a.shape[1]):
        h = a[:, i] * h + b[:, i]
        hs.append(h)
    return torch.stack(hs, dim=1)


def apply_rglru_block(cfg: ModelConfig, p, x, *, pos, state, enc_out, mode,
                      engine=None, tp=None, dp=None):
    """One RG-LRU block: gated linear recurrence + MLP. Under ``tp`` the
    recurrence is channel-parallel: ``wx``/``wg``/``wa``/``wi``
    column-parallel on this rank's channels, the conv, ``lam``, the
    gates and the scan elementwise on them (its decode state ``h`` and
    ``conv`` are those channels, as ``state_shardings`` places them),
    ``wo`` row-parallel with its sum; the MLP as in every block."""
    b, s, d = x.shape
    c_exp = 8.0
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    ch = _tp_range(d, tp)
    w = {k: p[k] for k in ("wx", "wg", "wa", "wi", "conv", "lam", "wo")}
    if ch is not None:
        xn = dist.copy_to_parallel(xn, tp.group)
        for k in ("wx", "wg", "wa", "wi", "conv", "lam"):
            w[k] = _tp_cols(p[k], *ch, d, tp)
        w["wo"] = _tp_cols(p["wo"], *ch, d, tp, dim=-2)
    u = xn @ w["wx"]
    g = _gelu(xn @ w["wg"])
    if mode == "full":
        conv_in = F.pad(u, (0, 0, 3, 0))
        uc = sum(conv_in[:, i:i + s] * w["conv"][i] for i in range(4))
    else:
        hist = torch.cat([state["conv"], u], dim=1)         # (B, 4, D)
        uc = torch.sum(hist * w["conv"], dim=1, keepdim=True)
    r = torch.sigmoid(xn @ w["wa"])
    i = torch.sigmoid(xn @ w["wi"])
    log_a = c_exp * r * F.logsigmoid(w["lam"])               # < 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2 * log_a), 1e-6)
                       ) * (i * uc)
    h0 = (state["h"] if state is not None
          else torch.zeros((b, u.shape[-1]), dtype=x.dtype, device=x.device))
    new_state = state
    if mode == "full":
        h = _rglru_scan(a, gated, h0)
        if state is not None:
            new_state = {"h": h[:, -1], "conv": conv_in[:, s:s + 3]
                         if s >= 3 else F.pad(u, (0, 0, 3 - s, 0))}
    else:
        h = (a * h0[:, None] + gated)
        new_state = {"h": h[:, -1],
                     "conv": torch.cat([state["conv"][:, 1:], u], dim=1)}
    y = (h * g) @ w["wo"]
    if ch is not None:
        y = dist.reduce_from_parallel(y, tp.group)
    x = x + y
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _apply_mlp(cfg, p["mlp"], xn2, d_ff=cfg.d_ff, engine=engine,
                          tp=tp, dp=dp), new_state


# ============================================================== RWKV-6 ====
def init_rwkv_block(cfg: ModelConfig, ini: Initializer) -> Dict[str, Any]:
    """Parameters of one RWKV-6 block (time mix + channel mix)."""
    d = cfg.d_model
    lora = max(32, d // 64)
    p = {
        "ln1": ini.zeros(d), "ln2": ini.zeros(d),
        "mix": ini(5, d, scale=0.5),          # base lerp for r,k,v,w,g
        "wr": ini(d, d, scale=d ** -0.5),
        "wk": ini(d, d, scale=d ** -0.5),
        "wv": ini(d, d, scale=d ** -0.5),
        "wg": ini(d, d, scale=d ** -0.5),
        "wo": ini(d, d, scale=(d * 2 * cfg.n_layers) ** -0.5),
        "w0": ini.zeros(d) - 6.0,             # decay bias (slow decay)
        "wa": ini(d, lora, scale=d ** -0.5),  # data-dependent decay LoRA
        "wb": ini(lora, d, scale=lora ** -0.5),
        "u": ini(d, scale=0.5),               # bonus
        "gn": ini.zeros(d),                   # group-norm scale
        # channel mix
        "cmix": ini(2, d, scale=0.5),
        "ck": ini(d, cfg.d_ff, scale=d ** -0.5),
        "cv": ini(cfg.d_ff, d, scale=cfg.d_ff ** -0.5),
        "cr": ini(d, d, scale=d ** -0.5),
    }
    return p


def _rwkv_time_mix(cfg, p, xn, xprev, state_wkv, tp=None):
    """xn (B,S,D); xprev (B,S,D) = token-shifted xn; returns (y, last wkv).
    The reference's ``lax.scan`` over S is a loop over S.

    Where its heads split over ``tp``, head-parallel (else every head on
    every rank): ``wr``/``wk``/``wv``/``wg`` column- and
    ``wo`` row-parallel, ``w0``/``u``/``gn`` and ``state_wkv`` this
    rank's heads' channels. The decay LoRA's inner vector is whole
    (``wa`` split over its columns, gathered after the tanh, before
    ``wb``'s columns of this rank), and the group-norm proxy's mean
    square is over the whole ``d_model``, summed over the ranks."""
    b, s, d = xn.shape
    hd = cfg.rwkv_head_dim
    ch = _tp_range(d, tp) if heads_split(cfg, tp) else None
    w = {k: p[k] for k in ("mix", "wr", "wk", "wv", "wg", "wa", "wb", "w0",
                           "u", "gn", "wo")}
    lora = p["wb"].shape[0]
    if ch is None and tp is not None:   # heads whole: every leaf whole
        for k in ("wr", "wk", "wv", "wg", "wb", "w0", "u", "gn"):
            w[k] = _whole(p[k], d, tp)
        w["wa"] = _whole(p["wa"], lora, tp)
        w["wo"] = _whole(p["wo"], d, tp, dim=-2)
    if ch is not None:
        xn = dist.copy_to_parallel(xn, tp.group)
        xprev = dist.copy_to_parallel(xprev, tp.group)
        w["mix"] = dist.copy_to_parallel(p["mix"], tp.group)
        for k in ("wr", "wk", "wv", "wg", "wb", "w0", "u", "gn"):
            w[k] = _tp_cols(p[k], *ch, d, tp)
        w["wo"] = _tp_cols(p["wo"], *ch, d, tp, dim=-2)
        if p["wa"].shape[-1] == lora:    # kept whole: its gradient summed
            w["wa"] = dist.copy_to_parallel(p["wa"], tp.group)
    nh = w["wr"].shape[-1] // hd
    mix = torch.sigmoid(w["mix"])

    def lerp(i):
        return xn * mix[i] + xprev * (1 - mix[i])
    r = (lerp(0) @ w["wr"]).reshape(b, s, nh, hd)
    k = (lerp(1) @ w["wk"]).reshape(b, s, nh, hd)
    v = (lerp(2) @ w["wv"]).reshape(b, s, nh, hd)
    inner = torch.tanh(lerp(3) @ w["wa"])
    if inner.shape[-1] != lora:      # this rank's LoRA columns: gather
        inner = dist.gather_from_parallel(inner, tp.group, -1)
    wdd = w["w0"] + inner @ w["wb"]
    dec = torch.exp(-torch.exp(wdd)).reshape(b, s, nh, hd)   # in (0,1)
    g = F.silu(lerp(4) @ w["wg"])
    u = w["u"].reshape(nh, hd)

    S = state_wkv
    ys = []
    for t in range(s):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], dec[:, t]
        kv = torch.einsum("bhi,bhj->bhij", k_t, v_t)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t,
                               S + u[None, :, :, None] * kv))
        S = w_t[..., None] * S + kv
    y = torch.stack(ys, dim=1).reshape(b, s, nh * hd)
    if ch is None:
        y = rms_norm(y, w["gn"], cfg.norm_eps)            # group-norm proxy
        return (y * g) @ w["wo"], S
    # the proxy over the whole d_model: its mean square summed over ranks
    sq = dist.sum_in_parallel(torch.sum(torch.square(y.to(torch.float32)),
                                        dim=-1, keepdim=True), tp.group)
    y = (y * torch.rsqrt(sq / d + cfg.norm_eps)).to(y.dtype) * (1.0 + w["gn"])
    return dist.reduce_from_parallel((y * g) @ w["wo"], tp.group), S


def _rwkv_channel_mix(cfg, p, xn2, xprev2, tp=None):
    """``sigmoid(xr @ cr) * (relu(xk @ ck)^2 @ cv)`` of the lerps of
    ``xn2`` and its token shift ``xprev2``. Under ``tp``: ``ck``
    column- and ``cv`` row-parallel with its sum, ``cr``
    column-parallel, its gate gathered whole to meet the whole sum."""
    d = xn2.shape[-1]
    ch = _tp_range(d, tp)
    w = {k: p[k] for k in ("cmix", "ck", "cv", "cr")}
    if ch is not None:
        xn2 = dist.copy_to_parallel(xn2, tp.group)
        xprev2 = dist.copy_to_parallel(xprev2, tp.group)
        w["cmix"] = dist.copy_to_parallel(p["cmix"], tp.group)
        f = cfg.d_ff       # an uneven share of a d_ff that does not split
        lo, hi = tp.index * f // tp.size, (tp.index + 1) * f // tp.size
        w["ck"] = _tp_cols(p["ck"], lo, hi, f, tp)
        w["cv"] = _tp_cols(p["cv"], lo, hi, f, tp, dim=-2)
        w["cr"] = _tp_cols(p["cr"], *ch, d, tp)
    cmix = torch.sigmoid(w["cmix"])
    xk = xn2 * cmix[0] + xprev2 * (1 - cmix[0])
    xr = xn2 * cmix[1] + xprev2 * (1 - cmix[1])
    kk = torch.square(torch.relu(xk @ w["ck"]))
    gate = torch.sigmoid(xr @ w["cr"])
    if ch is None:
        return gate * (kk @ w["cv"])
    return (dist.gather_out_of_parallel(gate, tp.group, -1)
            * dist.reduce_from_parallel(kk @ w["cv"], tp.group))


def apply_rwkv_block(cfg: ModelConfig, p, x, *, pos, state, enc_out, mode,
                     engine=None, tp=None, dp=None):
    """One RWKV-6 block: time mix + channel mix, with token shift (its
    projections are plain ``@``: no PIM scope reaches them, so ``dp`` is
    not read). Under ``tp`` (head-parallel, see :func:`_rwkv_time_mix`
    and :func:`_rwkv_channel_mix`) the decode state is this rank's
    shard: ``wkv`` its heads, ``tshift``/``cshift`` its channels, which
    are gathered whole for the lerps and stored back as this rank's
    channels of the new ones."""
    b, s, d = x.shape
    ch = _tp_range(d, tp)
    if state is None:            # zero states; the wkv of this rank's heads
        hd = cfg.rwkv_head_dim
        heads = ch if heads_split(cfg, tp) else None
        nh = (d if heads is None else heads[1] - heads[0]) // hd
        zero = x.new_zeros((b, d))
        state = {"wkv": x.new_zeros((b, nh, hd, hd)), "tshift": zero,
                 "cshift": zero}
    shift = {k: state[k] for k in ("tshift", "cshift")}
    for k, v in shift.items():
        if v.shape[-1] != d:
            shift[k] = dist.all_gather(v, tp.group, dim=-1)
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "full":
        xprev = torch.cat([shift["tshift"][:, None], xn[:, :-1]], dim=1)
    else:
        xprev = shift["tshift"][:, None]
    y, S_last = _rwkv_time_mix(cfg, p, xn, xprev, state["wkv"], tp)
    x = x + y
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mode == "full":
        xprev2 = torch.cat([shift["cshift"][:, None], xn2[:, :-1]], dim=1)
    else:
        xprev2 = shift["cshift"][:, None]
    y2 = _rwkv_channel_mix(cfg, p, xn2, xprev2, tp)
    new_state = {"wkv": S_last, "tshift": xn[:, -1], "cshift": xn2[:, -1]}
    for k in ("tshift", "cshift"):
        if state[k].shape[-1] != d:
            new_state[k] = new_state[k][..., ch[0]:ch[1]]
    return x + y2, new_state


# ========================================================== dispatch =======
def init_block(cfg: ModelConfig, ini: Initializer, kind: str):
    """Parameters of one block of layer kind ``kind``."""
    if kind in ("g", "l"):
        return init_attn_block(cfg, ini, kind)
    if kind == "m":
        return init_moe_block(cfg, ini)
    if kind == "d":
        return init_attn_block(cfg, ini, "g",
                               d_ff=cfg.moe.d_ff_dense or cfg.d_ff)
    if kind == "r":
        return (init_rwkv_block(cfg, ini) if cfg.family == "rwkv"
                else init_rglru_block(cfg, ini))
    raise ValueError(kind)


def apply_block(cfg: ModelConfig, kind: str, p, x, *, pos, state=None,
                enc_out=None, mode="full", engine=None, tp=None, dp=None):
    """Apply one block of layer kind ``kind``; returns (y, new_state).
    ``tp`` (:func:`tensor_parallel`) and ``dp`` (:func:`data_parallel`)
    for every kind."""
    kw = dict(pos=pos, state=state, enc_out=enc_out, mode=mode,
              engine=engine, tp=tp, dp=dp)
    if kind in ("g", "l"):
        return apply_attn_block(cfg, p, x, kind=kind, **kw)
    if kind == "d":
        return apply_attn_block(cfg, p, x, kind="g",
                                d_ff=cfg.moe.d_ff_dense or cfg.d_ff, **kw)
    if kind == "m":
        return apply_moe_block(cfg, p, x, **kw)
    if kind == "r":
        fn = (apply_rwkv_block if cfg.family == "rwkv"
              else apply_rglru_block)
        return fn(cfg, p, x, **kw)
    raise ValueError(kind)


def init_state(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
               dtype=torch.float32, enc_len: int = 0, device=None):
    """Zero decode-state for one block, on ``device``."""
    if kind in ("g", "l", "m", "d"):
        t = cache_len if kind != "l" else min(cfg.window, cache_len)
        t = max(t, 1)
        return {"self": {
            "k": torch.zeros((batch, t, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, t, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                             device=device),
            "length": torch.zeros((), dtype=torch.int32, device=device)}}
    if cfg.family == "rwkv":
        d = cfg.d_model
        nh = d // cfg.rwkv_head_dim
        return {"wkv": torch.zeros((batch, nh, cfg.rwkv_head_dim,
                                    cfg.rwkv_head_dim), dtype=dtype,
                                   device=device),
                "tshift": torch.zeros((batch, d), dtype=dtype, device=device),
                "cshift": torch.zeros((batch, d), dtype=dtype, device=device)}
    return {"h": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            "conv": torch.zeros((batch, 3, cfg.d_model), dtype=dtype,
                                device=device)}
