"""Public model API: build_model(config) -> Model (init/loss/serve fns).

The port's copy of ``repro.models.model``. A :class:`Model` is bound to
one :class:`repro_torch.engine.Engine` and lives on that engine's device:
its PIM-scope projections run through the engine, and its parameters and
decode states are made there. :func:`input_specs` gives the dry-run's
shape stand-ins for a shape cell's inputs.

Given a mesh of ranks (``mesh=``) the loss is this rank's
share of the global loss: its rows' masked sum over the masked-token
count of the whole batch (summed over the data axes), so the shares and
their gradients sum over the data ranks to the unsharded loss and its
gradients, however unevenly the ranks' labels are masked. Over a
``model`` axis the logits are sharded by vocabulary and the cross
entropy is vocab-parallel. ``init``, ``forward``, ``decode_step`` and
``init_decode_state`` take the mesh too: this rank's shards of the
parameters (drawn shard by shard), its rows, and its shards of the
decode states as ``state_shardings`` places them.

``forward`` and ``decode_step`` are the spans ``model.forward``
(``tokens``) and ``model.decode_step`` (``batch``) of
:mod:`repro_torch.obs` (under ``torch.profiler`` with the device
time of the kernels they launch): the whole step that the PIM phase
spans under them are shares of.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch import dist, obs
from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map_with_path

from . import transformer as T
from .blocks import tensor_parallel

__all__ = ["Model", "build_model", "input_specs", "abstract_params"]


@dataclass(frozen=True)
class Model:
    """One architecture's functions, bound to ``engine`` and ``device``."""

    cfg: ModelConfig
    engine: Any
    device: torch.device
    init: Callable[..., Any]
    loss: Callable[..., torch.Tensor]
    forward: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_decode_state: Callable[..., Any]


def build_model(cfg: ModelConfig, remat: bool = False, *, engine=None,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """The :class:`Model` of ``cfg`` on ``engine``; with ``remat`` its
    ``loss`` rematerialises each stacked unit in backward (see
    :func:`repro_torch.models.transformer.forward`).

    ``engine=None`` is :func:`repro_torch.engine.get_engine`: packed torch
    on the card, which raises without CUDA (it never falls back to the
    host; pass ``Engine("torch:device=cpu")`` for the CPU). The model's
    device is the engine's; ``device``, when given, must name it.
    """
    if engine is None:
        from repro_torch.engine import get_engine
        engine = get_engine()
    dev = engine.device
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"device {device} is not the engine's device "
                         f"{dev}: a model lives where its engine runs")

    def init(seed: Union[int, torch.Generator] = 0, dtype=torch.float32,
             mesh=None):
        """Parameters from ``seed`` (an int or a ``torch.Generator``;
        an int seeds a generator on the model's device). With a ``mesh``
        of ranks, this rank's shard of each leaf by the partition rules:
        the whole init's draws, each leaf (each block) sliced as it is
        drawn, so the shards equal ``shard_leaf`` of the whole init and
        the whole tree is never live."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return T.init_params(cfg, gen, dtype, place=_placer(mesh))

    def loss(params, batch, mesh=None) -> torch.Tensor:
        """The masked mean cross entropy of ``batch``; with a ``mesh``
        of ranks, this rank's share (see the module docstring)."""
        tokens = batch["tokens"]
        labels = batch["labels"]
        kwargs = {}
        if cfg.family == "vlm":
            kwargs["extra_embed"] = batch["patches"]
        if cfg.family == "encdec":
            kwargs["enc_frames"] = batch["frames"]
        logits, _ = T.forward(cfg, params, tokens, remat=remat,
                              engine=engine, mesh=mesh, **kwargs)
        if cfg.family == "vlm":   # patches prepended: score text tail only
            logits = logits[:, -tokens.shape[1]:]
        nll = _nll(cfg, logits, labels.long(), tensor_parallel(cfg, mesh))
        mask = (labels >= 0).to(torch.float32)
        count = torch.sum(mask)
        dp = dist.mesh_axis(mesh, ("pod", "data"))
        if dp.group is not None:      # the whole batch's masked tokens
            count = dist.all_reduce(count.detach().clone(), dp.group)
        return torch.sum(nll * mask) / torch.clamp_min(count, 1.0)

    def fwd(params, tokens, **kw):
        with obs.span("model.forward") as sp:
            if sp:
                sp.set(tokens=tokens.numel())
            return T.forward(cfg, params, tokens, engine=engine, **kw)

    def decode(params, token, position, states, mesh=None):
        with obs.span("model.decode_step") as sp:
            if sp:
                sp.set(batch=token.shape[0])
            return T.decode_step(cfg, params, token, position, states,
                                 engine=engine, mesh=mesh)

    def init_state(batch, cache_len, dtype=torch.float32, mesh=None):
        return T.init_decode_state(cfg, batch, cache_len, dtype, device=dev,
                                   mesh=mesh)

    return Model(cfg, engine, dev, init, loss, fwd, decode, init_state)


def _placer(mesh):
    """A tree of whole parameter leaves to this rank's shards of them by
    the partition rules on ``mesh`` (None without a mesh of ranks)."""
    if getattr(mesh, "comm", None) is None:
        return None
    from repro_torch.train.sharding import shard_leaf, spec_for_leaf

    def place(tree):
        return tree_map_with_path(
            lambda path, x: shard_leaf(mesh, x, spec_for_leaf(
                mesh, T._leaf_name(path), tuple(x.shape))), tree)
    return place


def _nll(cfg: ModelConfig, logits, labels, tp) -> torch.Tensor:
    """The reference's cross entropy, token by token: max-shifted
    log-sum-exp minus the label's logit (0 where labels < 0), float32.
    With ``logits`` sharded by vocabulary over ``tp``: the global max,
    the sum of exponentials and the label's logit (from the rank that
    holds it) each summed over the ranks."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    sharded = tp is not None and logits.shape[-1] != cfg.vocab_size
    if sharded:
        m = dist.all_reduce_max(m, tp.group)
    shifted = (logits - m).to(torch.float32)
    sumexp = torch.sum(torch.exp(shifted), dim=-1)
    if not sharded:
        lse = torch.log(sumexp) + m[..., 0]
        label_logit = torch.gather(
            logits, -1, labels.clamp_min(0)[..., None])[..., 0]
        label_logit = torch.where(labels >= 0, label_logit,
                                  0.0).to(torch.float32)
        return lse.to(torch.float32) - label_logit
    n = logits.shape[-1]
    lse = torch.log(dist.reduce_from_parallel(sumexp, tp.group)) + m[..., 0]
    ids = labels - tp.index * n
    mine = (labels >= 0) & (ids >= 0) & (ids < n)
    local = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    local = torch.where(mine, local, 0.0).to(torch.float32)
    return lse.to(torch.float32) - dist.reduce_from_parallel(local, tp.group)


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """``cfg``'s parameter tree as ``device="meta"`` tensors: the shapes
    and dtypes of :func:`repro_torch.models.transformer.init_params`,
    drawn under ``FakeTensorMode``; nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = T.init_params(cfg, torch.Generator().manual_seed(0), dtype)
    return T.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                            device="meta"), params)


def input_specs(cfg: ModelConfig, shape, dtype=torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of an assigned ``shape``
    (:class:`repro_torch.configs.ShapeSpec`): ``device="meta"`` tensors,
    which carry shape and dtype and allocate nothing. The reference's
    keys, shapes and dtypes: ``tokens``/``labels`` (B, S) int32 for
    train, ``tokens`` for prefill, with ``patches`` (vlm) or ``frames``
    (encdec) in ``dtype``; ``token``/``position`` (B, 1) int32 for
    decode."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    if shape.kind == "decode":   # one new token against a seq_len cache
        return {"token": spec((b, 1), torch.int32),
                "position": spec((b, 1), torch.int32)}
    out = {"tokens": spec((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = spec((b, s), torch.int32)
    if cfg.family == "vlm":
        out["patches"] = spec((b, cfg.n_patches, cfg.d_model), dtype)
    if cfg.family == "encdec":
        out["frames"] = spec((b, cfg.enc_frames, cfg.d_model), dtype)
    return out
