"""Plain reference: DeepSeek LLM (dense MHA) and DeepSeekMoE decoders with
the fixed-point semantics of every PIM projection, teacher-forced over
served sequences. Plain PyTorch; imports nothing but ``torch``.

The equations, as the configuration's model is defined in the port (each
departure from the published model is marked):

* embedding ``E[token] * sqrt(d_model)`` (published: no scale);
* RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` (published: ``* w``);
* attention: multi-head, RoPE with the half-split rotation and
  ``rope_theta``, causal ``softmax(q k^T / sqrt(head_dim)) v``;
* MLP ``(silu(x W1) * (x W3)) W2``;
* DeepSeekMoE: the first ``first_k_dense_replace`` layers dense at
  ``intermediate_size``, the rest MoE: router logits ``x R`` (a plain
  product), the top ``num_experts_per_tok`` experts, gates the softmax
  of those logits (published: softmax over all experts, not
  renormalised), routed SwiGLU experts of ``moe_intermediate_size``,
  plus the shared experts as one SwiGLU of ``n_shared_experts`` times
  that width; a MoE layer's attention out-projection is a plain product;
* the final RMSNorm and an untied LM head.

**PIM projections** (the head with ``pim_linear_mode`` ``pim``, the MLPs
and experts with ``pim_block_mode`` ``ffn`` or ``full``, attention's
q/k/v/o with ``full``): ``n``-bit symmetric quantisation, one scale per
column of a weight (one for a whole expert stack) and one per call for
the activations, ``scale = max(amax, 1e-8) / (2^(n-1) - 1)``, values
``round(x / scale)`` (half to even), the signed integer product taken
exactly (in float64, exact while ``K (2^(n-1))^2 < 2^53``), then
``float32(acc) * sx * sw``. The port takes the unsigned offset form
``q + 2^(n-1)`` with an analytic correction; the two are equal in
exact integers.

**Calls.** A served sequence is run with all its positions at once, but
each PIM projection takes its activation scale over the rows of one
call of the served program: the prefill (every prompt position of every
sequence of the batch) and each decode step (one position of every
sequence). ``starts`` gives each call's first position. A prefill longer
than the port's MoE dispatch chunk (32,768 tokens over the batch) is
split by the port into calls this reference does not follow.

Controls: ``tf32`` computes the float products (attention, the router,
a MoE layer's out-projection) in TF32; ``attn_dtype`` computes attention
in another dtype; ``n_bits`` overrides the PIM width.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["RefConfig", "reference_config", "Reference", "layer_blocks"]


@dataclass(frozen=True)
class RefConfig:
    """The sizes and flags the reference reads from a configuration."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_layers: int
    rope_theta: float
    eps: float
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    first_dense: int = 0
    pim_bits: int = 8
    pim_head: bool = False
    pim_ffn: bool = False
    pim_attn: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def reference_config(spec: Dict[str, Any]) -> RefConfig:
    """A configuration file's object (``bench/configs/<name>.json``) as
    the reference reads it."""
    pim = spec.get("pim", {})
    head = pim.get("pim_linear_mode", "off")
    block = pim.get("pim_block_mode", "none")
    if head not in ("off", "pim") or block not in ("none", "ffn", "full"):
        raise ValueError(f"PIM flags {pim} are not the reference's")
    moe = bool(spec.get("n_routed_experts"))
    return RefConfig(
        d_model=int(spec["hidden_size"]),
        n_heads=int(spec["num_attention_heads"]),
        n_kv_heads=int(spec.get("num_key_value_heads",
                                spec["num_attention_heads"])),
        d_ff=int(spec["intermediate_size"]),
        vocab=int(spec["vocab_size"]),
        n_layers=int(spec["num_hidden_layers"]),
        rope_theta=float(spec["rope_theta"]),
        eps=float(spec["rms_norm_eps"]),
        n_experts=int(spec.get("n_routed_experts") or 0),
        top_k=int(spec.get("num_experts_per_tok", 0)) if moe else 0,
        n_shared=int(spec.get("n_shared_experts", 0)) if moe else 0,
        d_expert=int(spec.get("moe_intermediate_size", 0)) if moe else 0,
        first_dense=int(spec.get("first_k_dense_replace", 0)) if moe else 0,
        pim_bits=int(pim.get("pim_linear_bits", 8)),
        pim_head=head == "pim",
        pim_ffn=block in ("ffn", "full"),
        pim_attn=block == "full")


def layer_blocks(params: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """The blocks of a parameter tree in the port's layout, layer by
    layer: ``prefix`` blocks, then the stacked ``scan`` units (unit ``i``
    of every slot in turn), then ``suffix`` blocks."""
    def at(tree, i):
        if isinstance(tree, dict):
            return {k: at(v, i) for k, v in tree.items()}
        return tree[i]
    yield from params.get("prefix") or []
    scan = params.get("scan") or []
    if scan:
        n = next(iter(_leaves(scan[0]))).shape[0]
        for i in range(n):
            for slot in scan:
                yield at(slot, i)
    yield from params.get("suffix") or []


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of ``x`` (B, S, H, D) at ``pos`` (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.to(torch.float32)[:, None, None] * freq      # (S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Quant:
    """Symmetric ``n``-bit quantisation as a PIM projection takes it."""

    def __init__(self, n_bits: int):
        self.qmax = 2 ** (n_bits - 1) - 1
        self.lo = -(2 ** (n_bits - 1))

    def scale(self, amax: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(amax, 1e-8) / self.qmax

    def ints(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x / scale), self.lo, self.qmax)


class Reference:
    """The reference model of ``cfg`` over the parameter tree ``params``
    (the port's layout; nothing is copied).

    ``row_block`` rows of logits are computed at a time and
    ``batch_block`` sequences of attention, so that the reference fits
    on the card beside the weights."""

    def __init__(self, cfg: RefConfig, params: Dict[str, Any], *,
                 n_bits: Optional[int] = None, tf32: bool = False,
                 attn_dtype: torch.dtype = torch.float32,
                 row_block: int = 2048, batch_block: int = 4):
        self.cfg = cfg
        self.params = params
        self.q = _Quant(n_bits or cfg.pim_bits)
        self.tf32 = tf32
        self.attn_dtype = attn_dtype
        self.row_block = row_block
        self.batch_block = batch_block

    # ------------------------------------------------------ projections --
    def _weight(self, w: torch.Tensor, per_column: bool = True):
        amax = (w.abs().amax(dim=-2, keepdim=True) if per_column
                else w.abs().amax())
        sw = self.q.scale(amax)
        return self.q.ints(w, sw).to(torch.float64), sw

    def _acts(self, x: torch.Tensor, gid: torch.Tensor, n_groups: int):
        """``x`` (T, K) rows of calls ``gid`` (T,): integers and the
        per-row scale (T, 1) of each row's call."""
        amax = torch.zeros(n_groups, dtype=x.dtype, device=x.device)
        amax = amax.scatter_reduce(0, gid, x.abs().amax(dim=-1), "amax")
        sx = self.q.scale(amax)[gid][:, None]
        return self.q.ints(x, sx).to(torch.float64), sx

    def linear(self, x: torch.Tensor, w: torch.Tensor, gid: torch.Tensor,
               n_groups: int, pim: bool) -> torch.Tensor:
        """``x`` (T, K) @ ``w`` (K, N): a PIM projection (scales per call
        and per column) or a plain float32 product."""
        if not pim:
            return x @ w
        xi, sx = self._acts(x, gid, n_groups)
        wi, sw = self._weight(w)
        return (xi @ wi).to(torch.float32) * sx * sw

    def _mlp(self, x, p, gid, n_groups):
        pim = self.cfg.pim_ffn
        h = F.silu(self.linear(x, p["w1"], gid, n_groups, pim)) * \
            self.linear(x, p["w3"], gid, n_groups, pim)
        return self.linear(h, p["w2"], gid, n_groups, pim)

    def _moe(self, x, p, gid, n_groups):
        """DeepSeekMoE's expert FFN of ``x`` (T, D)."""
        cfg = self.cfg
        r = x @ p["router"]
        gate, idx = torch.topk(r, cfg.top_k, dim=-1)           # (T, k)
        gate = torch.softmax(gate, dim=-1)
        pim = cfg.pim_ffn
        w1 = self._weight(p["we1"], False) if pim else None
        w3 = self._weight(p["we3"], False) if pim else None
        w2 = self._weight(p["we2"], False) if pim else None
        if pim:
            xi, sx = self._acts(x, gid, n_groups)
        t, k = idx.shape
        h = x.new_zeros((t, k, cfg.d_expert))
        for e in range(cfg.n_experts):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            if pim:
                a = xi[rows]
                h1 = (a @ w1[0][e]).to(torch.float32) * sx[rows] * w1[1]
                h3 = (a @ w3[0][e]).to(torch.float32) * sx[rows] * w3[1]
            else:
                h1, h3 = x[rows] @ p["we1"][e], x[rows] @ p["we3"][e]
            h[rows, slot] = F.silu(h1) * h3
        if pim:            # the down projection's scale: every routed pair
            amax = torch.zeros(n_groups, dtype=h.dtype, device=h.device)
            amax = amax.scatter_reduce(0, gid, h.abs().amax(dim=(1, 2)),
                                       "amax")
            sh = self.q.scale(amax)[gid][:, None]
        out = x.new_zeros((t, cfg.d_model))
        for e in range(cfg.n_experts):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            if pim:
                hi = self.q.ints(h[rows, slot], sh[rows]).to(torch.float64)
                y = (hi @ w2[0][e]).to(torch.float32) * sh[rows] * w2[1]
            else:
                y = h[rows, slot] @ p["we2"][e]
            out.index_add_(0, rows, y * gate[rows, slot][:, None])
        if cfg.n_shared:
            out = out + self._mlp(x, p["shared"], gid, n_groups)
        return out

    # -------------------------------------------------------- attention --
    def _attend(self, q, k, v):
        """Causal attention of (B, S, H, D) tensors, ``batch_block``
        sequences at a time."""
        b, s, h, d = q.shape
        rep = h // k.shape[2]
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        out = torch.empty_like(q)
        dt = self.attn_dtype
        for b0 in range(0, b, self.batch_block):
            sl = slice(b0, b0 + self.batch_block)
            sc = torch.einsum("bshd,bthd->bhst", q[sl].to(dt),
                              k[sl].to(dt)).to(torch.float32) * (d ** -0.5)
            sc = sc.masked_fill(~mask, float("-inf"))
            pr = torch.softmax(sc, dim=-1)
            del sc
            out[sl] = torch.einsum("bhst,bthd->bshd", pr.to(dt),
                                   v[sl].to(dt)).to(torch.float32)
            del pr
        return out

    def _block(self, x, p, pos, gid, n_groups):
        cfg = self.cfg
        b, s, d = x.shape
        t = b * s
        g = gid.repeat(b)                   # row (b, s) -> its call
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        xn = rms_norm(x, p["ln1"], cfg.eps).reshape(t, d)
        pa = cfg.pim_attn
        q = self.linear(xn, p["wq"], g, n_groups, pa).reshape(b, s, nh, hd)
        k = self.linear(xn, p["wk"], g, n_groups, pa).reshape(b, s, nkv, hd)
        v = self.linear(xn, p["wv"], g, n_groups, pa).reshape(b, s, nkv, hd)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        o = self._attend(q, k, v).reshape(t, nh * hd)
        del q, k, v
        moe = "router" in p
        x = x + self.linear(o, p["wo"], g, n_groups,
                            pa and not moe).reshape(b, s, d)
        xn = rms_norm(x, p["ln2"], cfg.eps).reshape(t, d)
        f = (self._moe(xn, p, g, n_groups) if moe
             else self._mlp(xn, p["mlp"], g, n_groups))
        return x + f.reshape(b, s, d)

    # ------------------------------------------------------------ serve --
    @torch.no_grad()
    def run(self, tokens: torch.Tensor, starts: Sequence[int],
            rows: torch.Tensor, choices: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
        """Teacher-forced over ``tokens`` (B, S): the prompt, then each
        served token fed back. ``starts``: the first position of each
        call (the prefill at 0, then each decode step). ``rows`` (R,):
        the positions whose logits are read.

        Returns per sequence and read position (B, R): ``max`` and
        ``argmax`` of the logits, and with ``choices`` (B, R) token ids
        ``at_choice``, the logit of each."""
        cfg, params = self.cfg, self.params
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            b, s = tokens.shape
            dev = tokens.device
            pos = torch.arange(s, device=dev)
            st = torch.as_tensor(list(starts), device=dev)
            gid = torch.bucketize(pos, st, right=True) - 1
            n_groups = len(starts)
            x = params["embed"][tokens.long()] * (cfg.d_model ** 0.5)
            for p in layer_blocks(params):
                x = self._block(x, p, pos, gid, n_groups)
            x = rms_norm(x, params["final_norm"], cfg.eps)
            return self._head(x, gid, n_groups, rows.to(dev), choices)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _head(self, x, gid, n_groups, rows, choices):
        cfg, params = self.cfg, self.params
        b, s, d = x.shape
        head = params["lm_head"] if "lm_head" in params else \
            params["embed"].T
        g = gid.repeat(b)
        flat = x.reshape(b * s, d)
        if cfg.pim_head:
            xi, sx = self._acts(flat, g, n_groups)
            wi, sw = self._weight(head)
        keep = (torch.arange(b, device=x.device)[:, None] * s
                + rows[None, :]).reshape(-1)            # (B R,) flat rows
        out: Dict[str, List[torch.Tensor]] = {"max": [], "argmax": [],
                                              "at_choice": []}
        ch = None if choices is None else choices.reshape(-1).long()
        for r0 in range(0, keep.numel(), self.row_block):
            sel = keep[r0:r0 + self.row_block]
            if cfg.pim_head:
                lg = (xi[sel] @ wi).to(torch.float32) * sx[sel] * sw
            else:
                lg = flat[sel] @ head
            am = torch.argmax(lg, dim=-1)         # the first best, as served
            mx = lg.gather(1, am[:, None])[:, 0]
            out["max"].append(mx)
            out["argmax"].append(am)
            if ch is not None:
                out["at_choice"].append(
                    lg.gather(1, ch[r0:r0 + self.row_block, None])[:, 0])
            del lg
        r = rows.numel()
        return {k: torch.cat(v).reshape(b, r) for k, v in out.items() if v}
