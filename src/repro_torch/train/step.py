"""Serve-step and prefill factories (the port's copy of the serving half
of ``repro.train.step``).

The reference jits each step with explicit shardings over its mesh and
donates the decode states. The port runs one unsharded model on one card:
``jit_for`` returns the step itself (no ``torch.compile``), and the decode
states update in place (:func:`repro_torch.models.transformer.decode_step`),
which is what the reference's donation buys.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model

__all__ = ["make_serve_step", "make_prefill"]


def make_serve_step(model: Model):
    """Returns (serve_step, jit_for(params, states, batch)).

    ``serve_step(params, states, token, position) -> (next_token,
    states)``: one greedy decode step, ``next_token`` (B, 1) int32."""

    def serve_step(params, states, token, position):
        logits, states = model.decode_step(params, token, position, states)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, states

    def jit_for(params_like, states_like, batch_like):
        return serve_step
    return serve_step, jit_for


def make_prefill(model: Model):
    """Returns (prefill, jit_for(params, batch)).

    ``prefill(params, batch) -> (B, 1)`` int32: the greedy next token
    after ``batch["tokens"]`` (with ``patches``/``frames`` for the VLM and
    enc-dec families)."""

    def prefill(params, batch):
        kwargs = {}
        if model.cfg.family == "vlm":
            kwargs["extra_embed"] = batch.get("patches")
        if model.cfg.family == "encdec":
            kwargs["enc_frames"] = batch.get("frames")
        logits, _ = model.forward(params, batch["tokens"], **kwargs)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    def jit_for(params_like, batch_like):
        return prefill
    return prefill, jit_for
