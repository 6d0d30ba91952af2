"""Attention: GQA/MQA, causal + sliding-window masks, KV-cache decode.

The port's copy of ``repro.models.attention``, in plain torch. All
functions take/return (B, S, H, D) tensors. GQA groups the query heads
over the KV heads with a reshape-free einsum, so KV is never repeated.
Masked scores take the finite :data:`NEG_INF` (not ``-inf``), so a fully
masked row softmaxes to a uniform row exactly as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .layers import softcap as _softcap

__all__ = ["attend", "decode_attend", "KVCache", "projection_shapes"]


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
    kpos_slot = torch.arange(t, device=k.device)
    # valid slots: those written within the last min(new_len, window or T)
    age = torch.remainder(slot - kpos_slot, t)          # 0 = newest
    valid = age < torch.clamp_max(new_len, t)
    if window is not None:
        valid &= age < window
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = _grouped_out(probs, v)
    return out, KVCache(k, v, new_len)
