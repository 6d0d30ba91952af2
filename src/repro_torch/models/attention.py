"""Attention: GQA/MQA, causal + sliding-window masks, KV-cache decode.

The port's copy of ``repro.models.attention``, in plain torch. All
functions take/return (B, S, H, D) tensors. GQA groups the query heads
over the KV heads with a reshape-free einsum, so KV is never repeated.
Masked scores take the finite :data:`NEG_INF` (not ``-inf``), so a fully
masked row softmaxes to a uniform row exactly as in the reference.

:func:`decode_attend_split` is the decode step against a cache whose
slots are split over the ranks of a model axis (the sequence-sharded
branch of ``state_shardings``): each rank's :func:`partial_attend` over
its slots, combined over the ranks (flash decoding).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import dist

from .layers import softcap as _softcap

__all__ = ["attend", "decode_attend", "decode_attend_split",
           "partial_attend", "KVCache", "projection_shapes"]


def projection_shapes(cfg) -> "list[Tuple[str, int, int]]":
    """The attention block's linear inventory: (name, in_dim, out_dim)
    for the q/k/v/o projections — plus the cross-attention xq/xk/xv/xo
    pair carried by enc-dec decoder blocks — the shapes the PIM block
    planner (:mod:`repro_torch.pim.planner`) lowers onto co-scheduled
    crossbar groups under ``cfg.pim_block_mode == "full"``. Kept next to
    the attention math so the planner can never drift from what the
    block computes.
    """
    d = cfg.d_model
    shapes = [("attn.q", d, cfg.q_dim),
              ("attn.k", d, cfg.kv_dim),
              ("attn.v", d, cfg.kv_dim),
              ("attn.o", cfg.q_dim, d)]
    if cfg.family == "encdec":
        shapes += [("attn.xq", d, cfg.q_dim),
                   ("attn.xk", d, cfg.kv_dim),
                   ("attn.xv", d, cfg.kv_dim),
                   ("attn.xo", cfg.q_dim, d)]
    return shapes


NEG_INF = -2.3819763e38


class KVCache(NamedTuple):
    """Ring-buffered KV cache. ``k``/``v``: (B, T, Hkv, D); ``length``:
    running token count (a 0-d int32 tensor on the cache's device). For
    windowed layers T = window and writes wrap modulo T."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def _grouped_scores(q, k):
    """(B,S,Hq,D) x (B,T,Hkv,D) -> (B, Hq, S, T) with GQA grouping."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    return scores.reshape(b, hkv * g, s, k.shape[1])


def _grouped_out(probs, v):
    b, h, s, t = probs.shape
    hkv = v.shape[2]
    g = h // hkv
    pg = probs.reshape(b, hkv, g, s, t)
    out = torch.einsum("bkgst,btkd->bskgd", pg, v)
    return out.reshape(b, s, h, v.shape[-1])


FLASH_THRESHOLD = 4096          # switch to blockwise above this S*T size
FLASH_BLOCK_Q = 512
FLASH_BLOCK_K = 512


def _mask(qpos, kpos, causal, window):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _dense_attend(q, k, v, *, causal, window, cap, q_offset):
    d = q.shape[-1]
    scores = _grouped_scores(q, k) * (d ** -0.5)
    scores = _softcap(scores, cap)
    s_len, t_len = scores.shape[-2], scores.shape[-1]
    m = _mask(torch.arange(s_len, device=q.device) + q_offset,
              torch.arange(t_len, device=q.device), causal, window)
    scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return _grouped_out(probs, v)


def _flash_attend(q, k, v, *, causal, window, cap, q_offset):
    """Blockwise online-softmax attention (memory O(bq*bk), plain torch).

    The peak live buffer is one (B, H, bq, bk) score tile instead of the
    full (B, H, S, T) matrix. The reference's two nested ``lax.scan`` /
    ``lax.map`` become two Python loops over 512 x 512 blocks; the
    padding, masks and running max/sum are the reference's, step for
    step.
    """
    b, s, hq, d = q.shape
    t = k.shape[1]
    bq = min(FLASH_BLOCK_Q, s)
    bk = min(FLASH_BLOCK_K, t)
    s_pad = (-s) % bq
    t_pad = (-t) % bk
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, s_pad))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, t_pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, t_pad))
    nq, nk = qp.shape[1] // bq, kp.shape[1] // bk
    scale = d ** -0.5
    dev = q.device

    outs = []
    for qi in range(nq):
        q_tile = qp[:, qi * bq:(qi + 1) * bq]            # (B, bq, Hq, D)
        qpos = qi * bq + torch.arange(bq, device=dev) + q_offset
        acc = torch.zeros((b, hq, bq, d), dtype=torch.float32, device=dev)
        m_run = torch.full((b, hq, bq), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((b, hq, bq), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_tile = kp[:, ki * bk:(ki + 1) * bk]
            v_tile = vp[:, ki * bk:(ki + 1) * bk]
            kpos = ki * bk + torch.arange(bk, device=dev)
            sc = _grouped_scores(q_tile, k_tile) * scale    # (B,H,bq,bk)
            sc = _softcap(sc, cap)
            valid = (kpos < t)[None, :]
            msk = _mask(qpos, kpos, causal, window) & valid
            sc = torch.where(msk[None, None], sc.to(torch.float32), NEG_INF)
            m_new = torch.maximum(m_run, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + _grouped_out(
                p.to(q.dtype), v_tile).transpose(1, 2).to(torch.float32)
            m_run = m_new
        out = acc / torch.clamp_min(l_run[..., None], 1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))    # (B, bq, Hq, D)
    return torch.cat(outs, dim=1)[:, :s]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           cap: Optional[float] = None,
           q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention (training / prefill).

    ``window``: sliding-window width (None = global). ``q_offset``:
    absolute position of q[0] relative to k[0] (cross/self alignment).
    Dispatches to the blockwise (flash) path for long sequences.
    """
    s, t = q.shape[1], k.shape[1]
    if s * t > FLASH_THRESHOLD * FLASH_THRESHOLD // 4 and s > 1:
        return _flash_attend(q, k, v, causal=causal, window=window, cap=cap,
                             q_offset=q_offset)
    return _dense_attend(q, k, v, causal=causal, window=window, cap=cap,
                         q_offset=q_offset)


def decode_attend(q: torch.Tensor, cache: KVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor, *, window: Optional[int] = None,
                  cap: Optional[float] = None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: append (k_new, v_new) then attend over the cache.

    q/k_new/v_new: (B, 1, H*, D). The new key and value are written into
    ``cache.k``/``cache.v`` in place, at ring slot ``length mod T`` (the
    reference's ``dynamic_update_slice``; the slot stays a device tensor,
    so a step never waits for the card). The returned cache holds the
    same buffers and ``length + 1``. The ring keeps the windowed layers'
    cache O(window).
    """
    t = cache.k.shape[1]
    slot = torch.remainder(cache.length, t).reshape(1).to(torch.int64)
    k, v = cache.k, cache.v
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))
    new_len = cache.length + 1

    d = q.shape[-1]
    scores = _grouped_scores(q, k) * (d ** -0.5)       # (B,H,1,T)
    scores = _softcap(scores, cap)
    # valid slots: those written within the last min(new_len, window or T)
    valid = _valid_slots(slot, new_len, torch.arange(t, device=k.device), t,
                         window)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = _grouped_out(probs, v)
    return out, KVCache(k, v, new_len)


def _valid_slots(slot, new_len, kpos_slot, t: int, window):
    """Which ring slots ``kpos_slot`` of a T-slot cache hold one of the
    last ``min(new_len, window or T)`` tokens, the newest at ``slot``."""
    age = torch.remainder(slot - kpos_slot, t)          # 0 = newest
    valid = age < torch.clamp_max(new_len, t)
    if window is not None:
        valid &= age < window
    return valid


def partial_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor, cap: Optional[float] = None):
    """One query token's attention over a part of the cache, before the
    softmax is normalised: q (B, 1, H, D), k/v (B, T, Hkv, D) this
    part's slots, ``valid`` (T,) which of them count. Returns float32
    ``(m, l, o)``: the scores' maximum and the sum of their exponentials
    shifted by it, each (B, H, 1, 1), and the exponential-weighted sum of
    the values (B, 1, H, D). The scores are :func:`decode_attend`'s,
    softcap and masks included."""
    d = q.shape[-1]
    scores = _softcap(_grouped_scores(q, k) * (d ** -0.5), cap)
    scores = torch.where(valid[None, None, None, :], scores,
                         NEG_INF).to(torch.float32)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    o = _grouped_out(p.to(q.dtype), v).to(torch.float32)
    return m, torch.sum(p, dim=-1, keepdim=True), o


def decode_attend_split(q: torch.Tensor, cache: KVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor, group, index: int, size: int, *,
                        window: Optional[int] = None,
                        cap: Optional[float] = None,
                        every_head: bool = False
                        ) -> Tuple[torch.Tensor, KVCache]:
    """:func:`decode_attend` against a T-slot ring split over ``size``
    ranks of ``group``: ``cache.k``/``cache.v`` (B, T/size, Hkv, D) hold
    slots ``[index T/size, (index + 1) T/size)``, ``q`` (B, 1, hq, D) this
    rank's query heads (block ``index`` of the ``size hq`` heads), and
    ``k_new``/``v_new`` (B, 1, Hkv, D) are the same on every rank.

    The new key and value go into slot ``length mod T`` on the rank that
    holds it: every rank writes its slot ``clamp(length mod T - index
    T/size)`` in place, the new entry where it is the slot and its own
    old one elsewhere, so the slot stays a device tensor and a step never
    waits for the card. Attention is the flash-decoding combine: the
    query heads gathered over the ranks, each rank's
    :func:`partial_attend` over its slots, the maxima's maximum (one
    all-reduce), then the sums and outputs rescaled to it and summed (one
    more); the rank keeps its own heads. Returns them (B, 1, hq, D) and
    the cache with the same buffers and ``length + 1``. With
    ``every_head`` ``q`` holds every query head on every rank (heads that
    the axis does not split): none is gathered, and all are returned.
    """
    t_l = cache.k.shape[1]
    t = t_l * size
    slot = torch.remainder(cache.length, t).reshape(1).to(torch.int64)
    local = slot - index * t_l
    mine = (local >= 0) & (local < t_l)
    at = local.clamp(0, t_l - 1)
    k, v = cache.k, cache.v
    k.index_copy_(1, at, torch.where(mine, k_new.to(k.dtype),
                                     k.index_select(1, at)))
    v.index_copy_(1, at, torch.where(mine, v_new.to(v.dtype),
                                     v.index_select(1, at)))
    new_len = cache.length + 1

    kpos_slot = index * t_l + torch.arange(t_l, device=k.device)
    valid = _valid_slots(slot, new_len, kpos_slot, t, window)
    hq = q.shape[2]
    q_all = q if every_head else dist.all_gather(q, group, dim=2)
    m, l, o = partial_attend(q_all, k, v, valid, cap)
    top = dist.all_reduce(m.clone(), group, "max")
    c = torch.exp(m - top).transpose(1, 2)              # (B, 1, H, 1)
    both = dist.all_reduce(torch.cat([o * c, l.transpose(1, 2) * c],
                                     dim=-1), group)
    out = both[..., :-1] / both[..., -1:]
    if not every_head:
        out = out[:, :, index * hq:(index + 1) * hq]
    out = out.to(q.dtype)
    return out, KVCache(k, v, new_len)
