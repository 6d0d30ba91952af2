"""Pytrees of tensors: the port's counterpart of ``jax.tree``.

A tree is nested dicts, lists, tuples and ``NamedTuple``s with tensors
(or anything else) at the leaves; ``None`` is an empty subtree, as in
JAX. Flattening visits leaves in **JAX's order**: a dict's keys sorted,
a ``NamedTuple``'s fields and a list's or tuple's items in order. Code
that indexes leaves by position (a checkpoint's ``leaf<i>``, a sum over
leaves) therefore sees the reference's order, so a checkpoint written by
either package restores in the other. Rebuilding keeps a dict's own key
order and a ``NamedTuple``'s type.

Key paths use the reference's entry types: :class:`DictKey`,
:class:`SequenceKey` and :class:`GetAttrKey`, and :func:`keystr` prints
a path as ``jax.tree_util.keystr`` does (``['scan'][0]['wq']``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["tree_map", "tree_map_with_path", "tree_flatten",
           "tree_flatten_with_path", "tree_unflatten", "tree_leaves",
           "TreeDef", "DictKey", "SequenceKey", "GetAttrKey", "keystr"]


@dataclass(frozen=True)
class DictKey:
    """Path entry of a dict value."""

    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


@dataclass(frozen=True)
class SequenceKey:
    """Path entry of a list or tuple item."""

    idx: int

    def __str__(self) -> str:
        return f"[{self.idx}]"


@dataclass(frozen=True)
class GetAttrKey:
    """Path entry of a ``NamedTuple`` field."""

    name: str

    def __str__(self) -> str:
        return f".{self.name}"


def keystr(path) -> str:
    """A key path as ``jax.tree_util.keystr`` prints it."""
    return "".join(str(k) for k in path)


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(t) -> List[Tuple[Any, Any]]:
    """(path entry, child) of a node in JAX's visiting order."""
    if isinstance(t, dict):
        return [(DictKey(k), t[k]) for k in sorted(t)]
    if _is_namedtuple(t):
        return [(GetAttrKey(f), getattr(t, f)) for f in t._fields]
    return [(SequenceKey(i), c) for i, c in enumerate(t)]


def _rebuild(t, children: dict):
    """A node like ``t`` whose children are ``children`` (keyed as
    :func:`_children` keys them), in ``t``'s own order."""
    if isinstance(t, dict):
        return {k: children[DictKey(k)] for k in t}
    if _is_namedtuple(t):
        return type(t)(*(children[GetAttrKey(f)] for f in t._fields))
    return type(t)(children[SequenceKey(i)] for i in range(len(t)))


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple))


def _child(t, key):
    if isinstance(key, DictKey):
        return t[key.key]
    if isinstance(key, GetAttrKey):
        return getattr(t, key.name)
    return t[key.idx]


# The walks below recurse through module-level functions: a nested
# function that calls itself is a reference cycle, which would hold what
# it closes over (``fn``, the flattened leaves) until the garbage
# collector runs, and a train step's gradients with them.
def _map(fn: Callable, path: tuple, t, rs: list):
    if t is None:
        return None
    if not _is_node(t):
        return fn(path, t, *rs)
    kids = {}
    for key, child in _children(t):
        kids[key] = _map(fn, path + (key,), child,
                         [_child(r, key) for r in rs])
    return _rebuild(t, kids)


def tree_map_with_path(fn: Callable, tree, *rest):
    """Map ``fn(path, leaf, *others)`` over the leaves of ``tree``;
    ``rest`` are trees of the same structure whose leaves are passed
    alongside. ``None`` stays ``None``."""
    return _map(fn, (), tree, list(rest))


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` (``jax.tree.map``): ``rest``
    are trees of the same structure whose leaves are passed alongside;
    ``None`` stays ``None``; dicts, lists, tuples and ``NamedTuple``s are
    rebuilt as they were."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_flatten_with_path(tree, is_leaf: Optional[Callable] = None
                           ) -> Tuple[List[Tuple[tuple, Any]], "TreeDef"]:
    """``[(path, leaf), ...]`` in JAX's order, and the tree's structure;
    a subtree for which ``is_leaf`` is true counts as one leaf."""
    out: List[Tuple[tuple, Any]] = []
    skeleton = _flatten((), tree, is_leaf, out)
    return out, TreeDef(skeleton, len(out))


def _flatten(path: tuple, t, is_leaf: Optional[Callable], out: list):
    if t is None:
        return None
    if not _is_node(t) or (is_leaf is not None and is_leaf(t)):
        out.append((path, t))
        return _LEAF
    return _rebuild(t, {key: _flatten(path + (key,), child, is_leaf, out)
                        for key, child in _children(t)})


def tree_flatten(tree) -> Tuple[list, "TreeDef"]:
    """(leaves in JAX's order, structure), as ``jax.tree.flatten``."""
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: "TreeDef", leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` (in JAX's order) at its
    leaves, as ``jax.tree.unflatten``."""
    return treedef.unflatten(leaves)


class _Leaf:
    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


class TreeDef:
    """A tree's structure: its nodes with a marker at each leaf."""

    def __init__(self, skeleton, num_leaves: int):
        self.skeleton = skeleton
        self.num_leaves = num_leaves

    def unflatten(self, leaves) -> Any:
        """The tree with ``leaves``, in JAX's order, at its leaves."""
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"{len(leaves)} leaves for a tree of "
                             f"{self.num_leaves}")
        it = iter(leaves)   # tree_map visits leaves in JAX's order
        return tree_map(lambda _: next(it), self.skeleton)

    def __repr__(self) -> str:
        return f"TreeDef({self.skeleton!r})"
