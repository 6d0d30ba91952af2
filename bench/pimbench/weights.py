"""Weights and prompts drawn from the run's seed, on the run's device.

The weights take the layout of the port's parameter tree (its shapes
and names, read from ``repro_torch.models.abstract_params``, which
allocates nothing, and kept in a disk cache: see :func:`param_layout`)
and are drawn by the benchmark, not by the port's ``init``: one
``torch.randn`` over every parameter at once, on a generator on the
device, in float32, each leaf then a view of that buffer scaled in
place. The same tensors go to the port and to the plain reference.

Scales: a weight matrix ``fan_in ** -0.5`` (its second to last axis),
the output projections (``wo``, ``w2``, ``we2``) also ``(2 n_layers) **
-0.5`` so the residual stream stays near unit size, the embedding
``d_model ** -0.5`` (the model multiplies it by ``d_model ** 0.5``), and
the RMS-norm weights, which enter as ``1 + w``, 0.1.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

import torch

__all__ = ["seed_int", "param_layout", "draw_weights", "PromptStream"]

_NORMS = {"ln1", "ln2", "final_norm"}
_OUT = {"wo", "w2", "we2"}


def seed_int(seed: int, stream: int = 0) -> int:
    """A generator seed in ``[0, 2^63)`` for ``stream`` of ``seed`` (any
    whole number, also one wider than 32 bits or negative)."""
    return (int(seed) * 0x9E3779B1 + stream * 0x85EBCA77) % (1 << 63)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        key = getattr(entry, "key", None)
        if isinstance(key, str):
            return key
    return ""


def _std(name: str, shape, n_layers: int, d_model: int) -> float:
    if name in _NORMS:
        return 0.1
    if name == "embed":
        return d_model ** -0.5
    std = shape[-2] ** -0.5
    if name in _OUT:
        std *= (2 * n_layers) ** -0.5
    return std


def _encode(node):
    """A tree's skeleton as JSON (None where it cannot be: a named tuple
    or a key that is not a string)."""
    if node is None:
        return None
    if isinstance(node, dict):
        items = [[k, _encode(v)] for k, v in node.items()]
        if any(not isinstance(k, str) for k, _ in items):
            raise TypeError("a dict key that is not a string")
        return {"dict": items}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        raise TypeError("a named tuple")
    if isinstance(node, (list, tuple)):
        return {type(node).__name__: [_encode(v) for v in node]}
    return 0


def _decode(node):
    """The tree :func:`_encode` wrote, with 0 at every leaf."""
    if node is None or node == 0:
        return node
    (kind, items), = node.items()
    if kind == "dict":
        return {k: _decode(v) for k, v in items}
    seq = [_decode(v) for v in items]
    return seq if kind == "list" else tuple(seq)


def _layout_key(cfg, dtype) -> str:
    """The configuration, the dtype and the source of the port's model
    code and tree walk: what the layout follows from."""
    import repro_torch.models as models
    import repro_torch.tree as tree
    h = hashlib.sha256(repr((cfg, str(dtype))).encode())
    for path in sorted(Path(models.__file__).parent.glob("*.py")) + [
            Path(tree.__file__)]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:32]


def param_layout(cfg, dtype=torch.float32, cache_dir=None):
    """``cfg``'s parameter tree in the port's layout as shapes only:
    ``[(leaf name, shape)]`` in the tree's order, and the tree's
    structure (nothing allocated).

    Read from the port's ``abstract_params``, which traces the port's
    init under ``FakeTensorMode``: some seconds of torch's tracing
    machinery to import. With ``cache_dir``, the result is kept there in
    a file named by the configuration, the dtype and the port's model
    sources, and read back by later runs."""
    from repro_torch.tree import tree_flatten
    path = None
    if cache_dir is not None:
        path = Path(cache_dir) / f"layout-{_layout_key(cfg, dtype)}.json"
        if path.exists():
            with open(path) as f:
                kept = json.load(f)
            flat = [(name, tuple(shape)) for name, shape in kept["leaves"]]
            return flat, tree_flatten(_decode(kept["tree"]))[1]
    from repro_torch.models.model import abstract_params
    from repro_torch.tree import tree_flatten_with_path
    tree = abstract_params(cfg, dtype)
    pairs, treedef = tree_flatten_with_path(tree)
    flat = [(_leaf_name(p), tuple(x.shape)) for p, x in pairs]
    if path is not None:
        try:
            skeleton = _encode(tree)
        except TypeError:
            return flat, treedef
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".part")
        with open(tmp, "w") as f:
            json.dump({"leaves": flat, "tree": skeleton}, f)
        os.replace(tmp, path)
    return flat, treedef


def draw_weights(cfg, seed: int, device, dtype=torch.float32,
                 layout=None):
    """The parameter tree of ``cfg`` from ``seed``: one draw of every
    parameter on ``device``, each leaf a view of it (``layout``:
    :func:`param_layout`'s, made here when not given)."""
    flat, treedef = layout or param_layout(cfg, dtype)
    total = sum(math.prod(shape) for _, shape in flat)
    gen = torch.Generator(device=device).manual_seed(seed_int(seed, 1))
    buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
    leaves, off = [], 0
    for name, shape in flat:
        n = math.prod(shape)
        leaf = buf[off:off + n].view(shape)
        leaf.mul_(_std(name, shape, cfg.n_layers, cfg.d_model))
        leaves.append(leaf)
        off += n
    return treedef.unflatten(leaves)


class PromptStream:
    """Prompt tokens for job after job, from ``seed``: job ``j``'s
    ``(batch, prompt_len)`` int32 tokens drawn uniformly over the
    vocabulary, on ``device``. Every seed gives the same sizes."""

    def __init__(self, seed: int, batch: int, prompt_len: int, vocab: int,
                 device):
        self.gen = torch.Generator(device=device).manual_seed(
            seed_int(seed, 2))
        self.shape = (batch, prompt_len)
        self.vocab = vocab
        self.device = device

    def next(self) -> torch.Tensor:
        """The next job's prompts."""
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device, dtype=torch.int64
                             ).to(torch.int32)
