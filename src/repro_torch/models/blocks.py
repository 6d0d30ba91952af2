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
``model`` axis, or None. Under it the attention and MLP blocks of the
dense decoders compute their shard in Megatron's layout, which is what
GSPMD makes of the partition rules: the q/k/v and w1/w3 projections
column-parallel on this rank's heads and columns, ``wo`` and ``w2``
row-parallel, followed by the sum over ranks. Their decode state is this
rank's shard of the KV cache as ``state_shardings`` places it: its KV
heads, or, where the KV heads do not split over the axis, its slots of
the sequence (attention then combines the ranks' partial softmaxes,
:func:`repro_torch.models.attention.decode_attend_split`). Every other
block kind raises ``NotImplementedError`` under it.

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
           "tensor_parallel", "data_parallel"]

# The ROADMAP item that ports what raises here under a sharded mesh.
TP_TODO = ("ROADMAP A: tensor parallelism for MoE, RG-LRU, RWKV, the VLM "
           "and enc-dec")


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
    or that axis holds one rank.

    Raises ``NotImplementedError`` under a ``model`` axis for any model
    but a dense decoder of attention blocks with heads that split over
    it."""
    if mesh is None or getattr(mesh, "comm", None) is None:
        return None
    tp = dist.mesh_axis(mesh, ("model",))
    if tp.size == 1:
        return None
    kinds = set(cfg.layer_kinds())
    if cfg.family != "decoder" or not kinds <= {"g", "l"}:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, block kinds "
            f"{sorted(kinds)} under a model axis of {tp.size}: {TP_TODO}")
    if cfg.n_heads % tp.size:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} heads do not split over a model "
            f"axis of {tp.size}")
    hq, g = cfg.n_heads // tp.size, cfg.n_heads // cfg.n_kv_heads
    if hq % g and g % hq:
        raise NotImplementedError(
            f"{cfg.name}: {hq} query heads a rank do not align with "
            f"groups of {g} over the KV heads")
    return tp


def data_parallel(mesh):
    """This rank's :class:`repro_torch.dist.ParallelAxis` on the data axes
    (``pod``, ``data``) of ``mesh``, or None when they hold one rank (or
    there is no mesh of ranks)."""
    dp = dist.mesh_axis(mesh, ("pod", "data"))
    return dp if dp.group is not None else None


def _group(axis):
    return None if axis is None else axis.group


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
                counts: torch.Tensor, *, engine=None,
                dp=None) -> torch.Tensor:
    """MoE per-expert grouped GEMM, PIM-offloaded under the ``"ffn"``
    scope (the expert FFNs are the block's FFN projections); ``xs``'s
    scale is the maximum over ``dp``."""
    if "ffn" not in cfg.pim_scopes():
        return ragged_dot(xs, we, counts)
    mode = "pim" if cfg.pim_linear_mode == "off" else cfg.pim_linear_mode
    return _engine(engine).ragged_linear(xs, we, counts,
                                         n_bits=cfg.pim_linear_bits,
                                         mode=mode, x_group=_group(dp))


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
               engine=None, tp=None, dp=None):
    # Same math as layers.swiglu/gelu_mlp, with each projection routed
    # through the PIM hook (plain matmul when the scope is off).
    if tp is not None and cfg.d_ff % tp.size == 0:
        return _apply_mlp_tp(cfg, p, x, tp, engine, dp)
    kw = dict(scope="ffn", engine=engine, dp=dp)
    h1 = pim_proj(cfg, x, p["w1"], **kw)
    if "w3" in p:
        gated = F.silu(h1) * pim_proj(cfg, x, p["w3"], **kw)
        return pim_proj(cfg, gated, p["w2"], **kw)
    return pim_proj(cfg, _gelu(h1), p["w2"], **kw)


def _apply_mlp_tp(cfg: ModelConfig, p, x, tp, engine, dp):
    """The MLP on this rank's ``d_ff / tp`` columns: ``w1``/``w3``
    column-parallel, ``w2`` row-parallel, then the sum over ranks. (A
    ``d_ff`` that does not split keeps every weight whole, and every
    rank computes the whole MLP.)"""
    f = cfg.d_ff // tp.size
    lo, hi = tp.index * f, (tp.index + 1) * f
    kw = dict(scope="ffn", engine=engine, dp=dp)
    xp = dist.copy_to_parallel(x, tp.group)
    h1 = pim_proj(cfg, xp, _tp_cols(p["w1"], lo, hi, cfg.d_ff, tp), **kw)
    if "w3" in p:
        h = F.silu(h1) * pim_proj(
            cfg, xp, _tp_cols(p["w3"], lo, hi, cfg.d_ff, tp), **kw)
    else:
        h = _gelu(h1)
    return pim_proj(cfg, h, _tp_cols(p["w2"], lo, hi, cfg.d_ff, tp, dim=-2),
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


def _qkv_tp(cfg: ModelConfig, p, xn, pos, tp, engine, dp):
    """q, k, v of this rank's heads (column-parallel projections)."""
    b, s, _ = xn.shape
    hd = cfg.hd
    q0, hq, k0, hk = _tp_heads(cfg, tp)
    kw = dict(scope="attn", engine=engine, dp=dp)
    xp = dist.copy_to_parallel(xn, tp.group)
    q = pim_proj(cfg, xp, _tp_cols(p["wq"], q0 * hd, (q0 + hq) * hd,
                                   cfg.q_dim, tp), **kw).reshape(b, s, hq, hd)
    kv = (k0 * hd, (k0 + hk) * hd, cfg.kv_dim, tp)
    k = pim_proj(cfg, xp, _tp_cols(p["wk"], *kv), **kw).reshape(b, s, hk, hd)
    v = pim_proj(cfg, xp, _tp_cols(p["wv"], *kv), **kw).reshape(b, s, hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, dist.copy_to_parallel(p["qn"], tp.group),
                     cfg.norm_eps)
        k = rms_norm(k, dist.copy_to_parallel(p["kn"], tp.group),
                     cfg.norm_eps)
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def _qkv(cfg: ModelConfig, p, xn, pos, engine, tp=None, dp=None):
    if tp is not None:
        return _qkv_tp(cfg, p, xn, pos, tp, engine, dp)
    b, s, _ = xn.shape
    kw = dict(scope="attn", engine=engine, dp=dp)
    q = pim_proj(cfg, xn, p["wq"], **kw).reshape(b, s, cfg.n_heads, cfg.hd)
    k = pim_proj(cfg, xn, p["wk"], **kw).reshape(b, s, cfg.n_kv_heads,
                                                 cfg.hd)
    v = pim_proj(cfg, xn, p["wv"], **kw).reshape(b, s, cfg.n_kv_heads,
                                                 cfg.hd)
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
    heads that do not split over the model axis), None when it holds a
    slice of the KV heads or there is no model axis. Raises when this
    rank's KV heads (:func:`_tp_heads`) are not its shard's."""
    if tp is None:
        return None
    heads = cfg.n_kv_heads % tp.size == 0
    hl = cache_k.shape[-2]
    shard = (tp.index * hl if heads else 0, hl)
    mine = _tp_heads(cfg, tp)[2:]
    if mine != shard:
        raise ValueError(f"{cfg.name}: rank {tp.index} of {tp.size} computes "
                         f"KV heads [{mine[0]}, {sum(mine)}), its cache "
                         f"shard holds [{shard[0]}, {sum(shard)})")
    return None if heads else tp


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


def apply_attn_block(cfg: ModelConfig, p, x, *, pos, state, enc_out, mode,
                     kind: str, engine=None, tp=None, dp=None):
    """One attention block: (self-attention [+ cross-attention] + MLP).
    Under ``tp``, self-attention and the MLP on this rank's heads and
    columns, with this rank's shard of the KV cache (see the module
    docstring)."""
    b, s, d = x.shape
    window = cfg.window if kind == "l" else None
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, xn, pos, engine, tp, dp)
    split = None if state is None else _seq_split(cfg, tp,
                                                  state["self"]["k"])
    new_state = state
    if mode in ("full", "encode"):
        o = attend(q, k, v, causal=(mode != "encode"), window=window,
                   cap=cfg.softcap_attn)
        if state is not None:     # prefill: leave the KV behind
            new_state = dict(state)
            new_state["self"] = _prefill_cache(state["self"], k, v, split)
    else:
        cache = KVCache(**state["self"])
        if split is None:
            o, cache = decode_attend(q, cache, k, v, window=window,
                                     cap=cfg.softcap_attn)
        else:
            o, cache = decode_attend_split(q, cache, k, v, split.group,
                                           split.index, split.size,
                                           window=window,
                                           cap=cfg.softcap_attn)
        new_state = dict(state)
        new_state["self"] = cache._asdict()
    attn = dict(scope="attn", engine=engine, dp=dp)
    if tp is not None:          # row-parallel out-projection, then the sum
        q0, hq = _tp_heads(cfg, tp)[:2]
        wo = _tp_cols(p["wo"], q0 * cfg.hd, (q0 + hq) * cfg.hd, cfg.q_dim,
                      tp, dim=-2)
        x = x + pim_proj(cfg, o.reshape(b, s, hq * cfg.hd), wo, tp=tp,
                         **attn)
    else:
        x = x + pim_proj(cfg, o.reshape(b, s, cfg.q_dim), p["wo"], **attn)

    if cfg.family == "encdec" and enc_out is not None:
        xn2 = rms_norm(x, p["lnx"], cfg.norm_eps)
        f = enc_out.shape[1]
        qx = pim_proj(cfg, xn2, p["xq"], **attn).reshape(b, s, cfg.n_heads,
                                                         cfg.hd)
        kx = pim_proj(cfg, enc_out, p["xk"], **attn).reshape(
            b, f, cfg.n_kv_heads, cfg.hd)
        vx = pim_proj(cfg, enc_out, p["xv"], **attn).reshape(
            b, f, cfg.n_kv_heads, cfg.hd)
        ox = attend(qx, kx, vx, causal=False)
        x = x + pim_proj(cfg, ox.reshape(b, s, cfg.q_dim), p["xo"], **attn)

    xn3 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _apply_mlp(cfg, p["mlp"], xn3, engine=engine, tp=tp, dp=dp)
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
            engine=None, dp=None) -> torch.Tensor:
    """Dropless top-k expert FFN over (B, S, D); long sequences are
    dispatched in chunks along S, so the sorted (T*k, D) dispatch
    activations stay O(chunk)."""
    b, s, d = x3.shape
    sc = max(1, MOE_CHUNK // max(1, b))
    if s > sc and s % sc == 0:
        ys = [_moe_ffn_chunk(cfg, p, x3[:, c:c + sc].reshape(b * sc, d),
                             engine=engine, dp=dp).reshape(b, sc, d)
              for c in range(0, s, sc)]
        return torch.cat(ys, dim=1)
    return _moe_ffn_chunk(cfg, p, x3.reshape(b * s, d),
                          engine=engine, dp=dp).reshape(b, s, d)


def _expert_counts(flat_e: torch.Tensor, n_experts: int):
    """Rows routed to each expert: (E,) int32 counts of ``flat_e``.

    A fake tensor (a shape-only trace, :mod:`repro_torch.launch.dryrun`)
    holds no routing to count, so the trace takes it balanced: T*k // E
    rows an expert, the remainder one each to the first experts. Dropless
    dispatch computes every routed pair whatever the routing, so the
    FLOPs are those of any real routing; real tensors are counted."""
    if is_fake(flat_e):
        n, rest = divmod(flat_e.numel(), n_experts)
        return [n + (i < rest) for i in range(n_experts)]
    return torch.bincount(flat_e, minlength=n_experts).to(torch.int32)


def _moe_ffn_chunk(cfg: ModelConfig, p, x2: torch.Tensor, *,
                   engine=None, dp=None) -> torch.Tensor:
    """Dropless dispatch: sort token-expert pairs by expert (stable), then
    grouped GEMMs over the ragged per-expert segments, then a scatter-add
    of the gated outputs back to their tokens.

    Every routed pair is computed (no capacity bound), so a token's
    output never depends on the other tokens of the dispatch and
    prefill equals token-by-token decode. The router is a plain ``@``,
    as in the reference.
    """
    e = cfg.moe
    t, d = x2.shape
    logits = x2 @ p["router"]
    gate, idx = torch.topk(logits, e.top_k, dim=-1)        # (T, k)
    gate = torch.softmax(gate.to(torch.float32), dim=-1).to(x2.dtype)

    flat_e = idx.reshape(-1)                               # (T*k,)
    flat_t = torch.arange(t, device=x2.device).repeat_interleave(e.top_k)
    order = torch.argsort(flat_e, stable=True)
    st, sg = flat_t[order], gate.reshape(-1)[order]
    counts = _expert_counts(flat_e, e.n_experts)

    xs = x2[st]                                            # (T*k, d)
    kw = dict(engine=engine, dp=dp)
    h = _pim_ragged(cfg, xs, p["we1"], counts, **kw)
    h3 = _pim_ragged(cfg, xs, p["we3"], counts, **kw)
    y = _pim_ragged(cfg, F.silu(h) * h3, p["we2"], counts, **kw)
    out = torch.zeros_like(x2).index_add_(0, st, y * sg[:, None])
    if e.n_shared:
        out = out + _apply_mlp(cfg, p["shared"], x2, **kw)
    return out


def apply_moe_block(cfg: ModelConfig, p, x, *, pos, state, enc_out, mode,
                    engine=None, dp=None):
    """One MoE block: self-attention (``wo`` plain) + the expert FFN."""
    b, s, d = x.shape
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, xn, pos, engine, dp=dp)
    new_state = state
    if mode == "full":
        o = attend(q, k, v, causal=True, cap=cfg.softcap_attn)
    else:
        o, cache = decode_attend(q, KVCache(**state["self"]), k, v,
                                 cap=cfg.softcap_attn)
        new_state = dict(state)
        new_state["self"] = cache._asdict()
    x = x + (o.reshape(b, s, cfg.q_dim) @ p["wo"])
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + moe_ffn(cfg, p, xn2, engine=engine, dp=dp), new_state


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
                      engine=None, dp=None):
    """One RG-LRU block: gated linear recurrence + MLP."""
    b, s, d = x.shape
    c_exp = 8.0
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    u = xn @ p["wx"]
    g = _gelu(xn @ p["wg"])
    if mode == "full":
        conv_in = F.pad(u, (0, 0, 3, 0))
        uc = sum(conv_in[:, i:i + s] * p["conv"][i] for i in range(4))
    else:
        hist = torch.cat([state["conv"], u], dim=1)         # (B, 4, D)
        uc = torch.sum(hist * p["conv"], dim=1, keepdim=True)
    r = torch.sigmoid(xn @ p["wa"])
    i = torch.sigmoid(xn @ p["wi"])
    log_a = c_exp * r * F.logsigmoid(p["lam"])               # < 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2 * log_a), 1e-6)
                       ) * (i * uc)
    h0 = (state["h"] if state is not None
          else torch.zeros((b, d), dtype=x.dtype, device=x.device))
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
    y = (h * g) @ p["wo"]
    x = x + y
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _apply_mlp(cfg, p["mlp"], xn2, engine=engine,
                          dp=dp), new_state


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


def _rwkv_time_mix(cfg, p, xn, xprev, state_wkv):
    """xn (B,S,D); xprev (B,S,D) = token-shifted xn; returns (y, last wkv).
    The reference's ``lax.scan`` over S is a loop over S."""
    b, s, d = xn.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd
    mix = torch.sigmoid(p["mix"])

    def lerp(i):
        return xn * mix[i] + xprev * (1 - mix[i])
    r = (lerp(0) @ p["wr"]).reshape(b, s, nh, hd)
    k = (lerp(1) @ p["wk"]).reshape(b, s, nh, hd)
    v = (lerp(2) @ p["wv"]).reshape(b, s, nh, hd)
    wdd = p["w0"] + torch.tanh(lerp(3) @ p["wa"]) @ p["wb"]
    w = torch.exp(-torch.exp(wdd)).reshape(b, s, nh, hd)   # in (0,1)
    g = F.silu(lerp(4) @ p["wg"])
    u = p["u"].reshape(nh, hd)

    S = state_wkv
    ys = []
    for t in range(s):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = torch.einsum("bhi,bhj->bhij", k_t, v_t)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t,
                               S + u[None, :, :, None] * kv))
        S = w_t[..., None] * S + kv
    y = torch.stack(ys, dim=1).reshape(b, s, d)
    y = rms_norm(y, p["gn"], cfg.norm_eps)                # group-norm proxy
    return (y * g) @ p["wo"], S


def apply_rwkv_block(cfg: ModelConfig, p, x, *, pos, state, enc_out, mode,
                     engine=None, dp=None):
    """One RWKV-6 block: time mix + channel mix, with token shift (its
    projections are plain ``@``: no PIM scope reaches them, so ``dp`` is
    not read)."""
    b, s, d = x.shape
    if state is None:
        state = init_state(cfg, "r", b, 0, x.dtype, device=x.device)
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "full":
        xprev = torch.cat([state["tshift"][:, None], xn[:, :-1]], dim=1)
    else:
        xprev = state["tshift"][:, None]
    y, S_last = _rwkv_time_mix(cfg, p, xn, xprev, state["wkv"])
    x = x + y
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mode == "full":
        xprev2 = torch.cat([state["cshift"][:, None], xn2[:, :-1]], dim=1)
    else:
        xprev2 = state["cshift"][:, None]
    cmix = torch.sigmoid(p["cmix"])
    xk = xn2 * cmix[0] + xprev2 * (1 - cmix[0])
    xr = xn2 * cmix[1] + xprev2 * (1 - cmix[1])
    kk = torch.square(torch.relu(xk @ p["ck"]))
    y2 = torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"])
    new_state = {"wkv": S_last, "tshift": xn[:, -1], "cshift": xn2[:, -1]}
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
    ``tp`` (:func:`tensor_parallel`) only for attention blocks; ``dp``
    (:func:`data_parallel`) for every kind."""
    kw = dict(pos=pos, state=state, enc_out=enc_out, mode=mode,
              engine=engine, dp=dp)
    if kind in ("g", "l"):
        return apply_attn_block(cfg, p, x, kind=kind, tp=tp, **kw)
    if tp is not None:
        raise NotImplementedError(f"block kind {kind!r} under a model axis "
                                  f"of {tp.size}: {TP_TODO}")
    if kind == "d":
        return apply_attn_block(cfg, p, x, kind="g", **kw)
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
