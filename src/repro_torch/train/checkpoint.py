"""Atomic, mesh-shape-agnostic checkpointing in the reference's format.

The port's copy of ``repro.train.checkpoint``. Layout::

    <dir>/step_000000123.tmp.<nonce>/   # staged
        manifest.json                    # treedef, shapes, dtypes, step
        proc00.npz                       # leaf<i>, i in JAX's flatten order
    <dir>/step_000000123/               # atomic rename publish

* leaves are numbered in JAX's flatten order
  (:func:`repro_torch.tree.tree_flatten`), so a checkpoint written by
  either package restores in the other with equal leaves; the manifest's
  ``treedef`` string is the one field that differs, and restore never
  reads it;
* the manifest stores logical shapes, not placements: restore puts each
  leaf where the caller's tree has it;
* publish is a directory rename: a reader never observes a torn step;
* integrity: per-array CRC32 in the manifest, verified on load;
* retention: the last 3 steps.

Sharded (``mesh`` over ``torch.distributed`` ranks, with the tree's
``specs``): save gathers every leaf whole on every rank of the mesh and
its first rank writes the same format (each leaf gathered in turn and
kept on the writer's host), so a checkpoint does not depend
on the mesh that wrote it; restore reads whole leaves on every rank and
slices each to this rank's shard on the *current* mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import dist
from repro_torch.tree import tree_flatten

from .sharding import gather_leaf, shard_leaf, spec_leaves

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "latest_steps"]


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.comm is not None


def _writer(mesh) -> bool:
    return not _sharded(mesh) or not any(mesh.comm.coords)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    process_index: int = 0, *, mesh=None,
                    specs=None) -> str:
    """Write ``tree`` as step ``step`` under ``ckpt_dir`` (staged, then
    renamed into place), keep the last 3 steps, and return the step's
    directory. With a ``mesh`` of ranks and ``specs`` (the tree's spec
    tree) every rank of the mesh calls it: the leaves are gathered whole,
    the mesh's first rank writes, and all wait for the publish."""
    if _sharded(mesh):
        tree = _gathered_to_host(mesh, tree, specs)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if _writer(mesh):
        _write(ckpt_dir, final, step, tree, process_index)
    if _sharded(mesh):
        dist.barrier(mesh.comm.axis(mesh.axis_names).group)
    return final


def _gathered_to_host(mesh, tree: Any, specs: Any) -> Any:
    """``tree``'s leaves gathered whole one at a time (every rank of the
    mesh takes part), each kept on the host by the writer and dropped by
    the others, so a rank's device holds one whole leaf at a time."""
    leaves, treedef = tree_flatten(tree)
    writer = _writer(mesh)
    out = []
    for x, spec in zip(leaves, spec_leaves(specs, len(leaves))):
        whole = gather_leaf(mesh, x, spec).detach()
        out.append(whole.cpu() if writer else None)
        del whole
    return treedef.unflatten(out) if writer else None


def _crc(arr: np.ndarray) -> int:
    """CRC32 of ``arr``'s bytes in C order (the reference's
    ``crc32(ascontiguousarray(arr).tobytes())``, read in place)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _write(ckpt_dir: str, final: str, step: int, tree: Any,
           process_index: int) -> None:
    leaves, treedef = tree_flatten(tree)
    os.makedirs(ckpt_dir, exist_ok=True)
    stage = final + f".tmp.{uuid.uuid4().hex[:8]}"
    os.makedirs(stage, exist_ok=True)

    arrays: Dict[str, np.ndarray] = {}
    meta = []
    for i, leaf in enumerate(leaves):
        arr = leaf.detach().cpu().numpy()
        arrays[f"leaf{i}"] = arr
        meta.append({
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc": _crc(arr),
        })
    np.savez(os.path.join(stage, f"proc{process_index:02d}.npz"), **arrays)
    manifest = {
        "step": step,
        "treedef": str(treedef),
        "n_leaves": len(leaves),
        "leaves": meta,
        "format": 1,
    }
    with open(os.path.join(stage, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(stage, final)
    # retention: keep last 3
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-3]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> List[int]:
    """The published steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp." not in name:
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest published step, or None."""
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                       device=None, *, mesh=None,
                       specs=None) -> Tuple[Any, int]:
    """Restore step ``step`` (default the newest) into the structure of
    ``like``. Each leaf goes to ``device``, or by default to the device
    of the corresponding leaf of ``like``, and takes that leaf's
    ``requires_grad``. Returns (tree, step); raises ``IOError`` on a CRC
    mismatch. With a ``mesh`` of ranks and ``specs``, ``like`` holds this
    rank's shards: each whole leaf is read and sliced by its spec on
    ``mesh`` (and must come out shaped as ``like``'s)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, treedef = tree_flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError("checkpoint/tree structure mismatch: "
                         f"{manifest['n_leaves']} vs {len(leaves_like)}")
    shard_specs = (spec_leaves(specs, len(leaves_like)) if _sharded(mesh)
                   else None)
    out = []
    with np.load(os.path.join(path, "proc00.npz")) as data:
        for i, leaf in enumerate(leaves_like):
            arr = data[f"leaf{i}"]
            want = manifest["leaves"][i]
            if _crc(arr) != want["crc"]:
                raise IOError(f"checkpoint corruption in leaf {i}")
            t = torch.from_numpy(arr)
            if shard_specs is not None:
                t = shard_leaf(mesh, t, shard_specs[i])
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(f"leaf {i}: shard {tuple(t.shape)} "
                                     f"of {tuple(arr.shape)} is not the "
                                     f"{tuple(leaf.shape)} asked for")
            t = t.to(leaf.device if device is None else device)
            if leaf.requires_grad:
                t.requires_grad_()
            out.append(t)
    return treedef.unflatten(out), step
