"""Nested containers of tensors, walked the way ``jax.tree_util`` walks
them: a dict's keys in sorted order, a dataclass's fields in declaration
order, a list's or tuple's items by index, ``None`` as an empty subtree,
anything else a leaf.

The order matters twice.  ``optim.adamw.global_norm`` sums the leaves'
squares in it, as the reference sums ``jax.tree.leaves`` (a dict's
insertion order would change the norm by an ulp), and
``checkpoint.manager`` names each leaf by its path in it (``params/
layers/attn/wq``, ``opt/mu/embed``, ``step``), the reference's file and
manifest names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """``("a/b/c", leaf)`` for every leaf, in the reference's order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for k, c in kids:
            walk(c, path + (k,))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    """The leaves in the reference's order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure; the
    result has ``tree``'s structure (dicts keep their insertion order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c, *(r[i] for r in rest))
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over every leaf, keeping ``tree``'s structure
    (paths as ``flatten_with_path`` names them)."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name), sub(f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, c, sub(i))
                          for i, c in enumerate(tree))
    return fn(path, tree)


def unflatten_into(template, values: Dict[str, Any]):
    """``template``'s structure with each leaf replaced by ``values`` under
    its path name (the reference's ``_unflatten_into``)."""
    return map_with_path(lambda name, _: values[name], template)
