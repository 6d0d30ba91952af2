"""Train-step, serve-step and prefill factories (the port's copy of
``repro.train.step``).

The reference jits each step with explicit shardings over its mesh and
donates its buffers. The port runs one unsharded model on one card:
``jit_for`` returns the step itself (no ``torch.compile``); the
optimizer updates the parameters and moments in place and the decode
states update in place (:func:`repro_torch.models.transformer.decode_step`),
which is what the reference's donation buys.

``make_train_step``: a microbatched (gradient-accumulation) AdamW step.
Forward and backward run one microbatch at a time, so only one
microbatch's activations are ever live (the reference's ``value_and_grad``
inside its ``lax.scan``); with a model built with ``remat=True`` each
stacked unit is also rematerialised in backward.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compress import ef_compress_tree
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["make_train_step", "make_serve_step", "make_prefill"]


def make_train_step(model: Model, opt_cfg: AdamWConfig, mesh=None, *,
                    microbatches: int = 1, compress_grads: bool = False):
    """Returns ``(train_step, init_fn, jit_for)``.

    ``init_fn(seed=0, dtype=float32) -> (params, opt_state, residual)``:
    the model's parameters from ``seed`` with every leaf
    ``requires_grad_``, zero AdamW state, and the error-feedback residual
    (zeros shaped as the parameters) under ``compress_grads``, else None.

    ``train_step(params, opt_state, residual, batch) -> (params,
    opt_state, residual, metrics)``: the batch's leading axis splits into
    ``microbatches`` equal parts; each part's loss and gradients
    (``torch.autograd.grad``) are taken in turn and summed into a float32
    accumulator, and the sums are scaled by ``1 / microbatches``. Then
    int8 error feedback (``compress_grads``) and AdamW, in place.
    ``metrics``: ``loss``, ``grad_norm`` and ``lr``, 0-d tensors on the
    model's device.

    ``mesh`` is accepted for the reference's signature; the port runs
    unsharded (:mod:`repro_torch.train.sharding`), and ``jit_for(params,
    batch)`` returns ``train_step``.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def init_fn(seed=0, dtype=torch.float32):
        params = model.init(seed, dtype)
        tree_map(lambda x: x.requires_grad_(), params)
        opt = adamw_init(params)
        resid = (tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                          params) if compress_grads else None)
        return params, opt, resid

    def grads_microbatched(params, batch):
        leaves, treedef = tree_flatten(params)

        def value_and_grad(one):
            loss = model.loss(params, one)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), list(grads)

        if microbatches == 1:
            loss, grads = value_and_grad(batch)
            return loss, treedef.unflatten(grads)
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{microbatches} microbatches")
        size = rows // microbatches
        total = None
        acc = None
        for i in range(microbatches):
            one = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, grads = value_and_grad(one)
            if acc is None:     # 0 + g: the first sum is g itself
                total = loss
                acc = [g.to(torch.float32) for g in grads]
            else:
                total = total + loss
                # Out of place, one leaf at a time: autograd may hand one
                # tensor to two leaves, or an expanded one, so its
                # outputs are not written; each old sum is freed as it
                # is replaced.
                for k in range(len(acc)):
                    acc[k] = acc[k] + grads[k]
            del grads   # not held through the next microbatch's backward
        inv = 1.0 / microbatches
        for k in range(len(acc)):
            acc[k] = acc[k] * inv
        return total * inv, treedef.unflatten(acc)

    def train_step(params, opt_state, residual, batch):
        loss, grads = grads_microbatched(params, batch)
        if compress_grads:
            grads, residual = ef_compress_tree(grads, residual)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        return params, opt_state, residual, metrics

    def jit_for(params_like, batch_like):
        return train_step
    return train_step, init_fn, jit_for


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
