"""Trees of tensors: nested dicts, lists and tuples (and dataclasses, such
as ``GraphBatch``, read as their fields), walked in the order JAX walks a
pytree — dict keys sorted, sequences and fields in order, ``None`` an empty
subtree — so a flattened list of leaves lines up with the reference's
``jax.tree.leaves`` of the same structure.  :func:`keystr` writes a leaf's
path as ``jax.tree_util.keystr`` does (``['layers'][0]['w']``), which is
what the checkpoint manifests of both packages record.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "tree_paths",
           "keystr"]


def _children(node) -> List[Tuple[Any, Any]]:
    """``[(key, child)]`` of a container node in JAX's order, or None for a
    leaf.  A key is a dict key, a sequence index or ``.field``."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [("." + f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(node, path, leaves, paths, is_leaf=None):
    if node is None:
        return
    kids = None if is_leaf is not None and is_leaf(node) else \
        _children(node)
    if kids is None:
        leaves.append(node)
        paths.append(path)
        return
    for key, child in kids:
        _flatten(child, path + (key,), leaves, paths, is_leaf)


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves in JAX's order; a node for which ``is_leaf`` is true is a
    leaf, as with ``jax.tree.leaves(..., is_leaf=)``."""
    leaves, paths = [], []
    _flatten(tree, (), leaves, paths, is_leaf)
    return leaves


def tree_paths(tree) -> list:
    """Each leaf's :func:`keystr` path, in leaf order."""
    leaves, paths = [], []
    _flatten(tree, (), leaves, paths)
    return [keystr(p) for p in paths]


def keystr(path) -> str:
    out = []
    for key in path:
        if isinstance(key, str) and key.startswith("."):
            out.append(key)
        else:
            out.append(f"[{key!r}]")
    return "".join(out)


def tree_unflatten(structure, leaves: list):
    """A tree shaped as ``structure`` whose leaves are ``leaves`` in
    order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            new = {k: build(c) for k, c in kids}
            return {k: new[k] for k in node}  # keep the caller's key order
        if isinstance(node, (list, tuple)):
            vals = [build(c) for _, c in kids]
            if isinstance(node, list):
                return vals
            return type(node)(*vals) if hasattr(node, "_fields") \
                else tuple(vals)
        return dataclasses.replace(node, **{k[1:]: build(c)
                                            for k, c in kids})

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(o)} leaves against "
                             f"{len(leaves)}")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])
