"""Shared neural primitives (pure functions over explicit parameter trees).

The port's copy of ``repro.models.layers``, on torch tensors. Every
function computes on the device of its input. :class:`Initializer` draws
from an explicit :class:`torch.Generator` on the device the parameters
live on; it cannot reproduce ``jax.random`` (tests that hold the port
against the reference carry the reference's parameters across with
:func:`repro_torch.convert.params_from_numpy`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "layer_norm", "softcap", "rope", "swiglu", "gelu_mlp",
           "dense_init", "Initializer"]


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis with the ``(1 + w)`` scale."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1,
                     keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm over the last axis (biased variance, as ``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``tanh(x / cap) * cap``; ``cap=None`` is the identity."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D) with D even; positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    # positions (..., S) -> (..., S, 1, 1) broadcast over heads and dims
    ang = positions[..., :, None, None].to(torch.float32) * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w1, w3, w2):
    """SwiGLU MLP: ``(silu(x @ w1) * (x @ w3)) @ w2``."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def gelu_mlp(x, w1, w2):
    """GELU MLP with the tanh approximation (``jax.nn.gelu``'s default)."""
    return F.gelu(x @ w1, approximate="tanh") @ w2


class Initializer:
    """Deterministic, cheap parameter init: normal draws from one explicit
    ``generator``, in call order, on the generator's device."""

    def __init__(self, generator: torch.Generator, scale: float = 0.02):
        self.generator = generator
        self.device = generator.device
        self.scale = scale
        self._n = 0

    def __call__(self, *shape, scale: Optional[float] = None,
                 dtype=torch.float32) -> torch.Tensor:
        self._n += 1
        s = self.scale if scale is None else scale
        return (torch.randn(shape, generator=self.generator,
                            dtype=torch.float32, device=self.device)
                * s).to(dtype)

    def zeros(self, *shape, dtype=torch.float32) -> torch.Tensor:
        """A zero tensor on the generator's device (counts as a draw, as
        the reference's does)."""
        self._n += 1
        return torch.zeros(shape, dtype=dtype, device=self.device)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """An ``(in_dim, out_dim)`` weight, normal with std ``in_dim ** -0.5``."""
    return (torch.randn((in_dim, out_dim), generator=generator,
                        dtype=torch.float32, device=generator.device)
            * (in_dim ** -0.5)).to(dtype)
