"""The port's parameter and state trees: nested dicts, lists and tuples
with tensors (or other values) at the leaves, walked in the order
``jax.tree_util`` walks the reference's pytrees (dict keys sorted, lists
and tuples in order, ``None`` an empty subtree).

A leaf's path is the reference's checkpoint key scheme
(``repro/checkpoint/lark_store.py: put_pytree``): dict keys as they are,
list and tuple indices as ``[i]``, joined by "/".
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) \
        -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaves_with_paths(tree[key], prefix + (str(key),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += leaves_with_paths(sub, prefix + (f"[{i}]",))
        return out
    return [(prefix, tree)]


def path_name(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves):
    """A tree of `like`'s structure with `new_leaves` in flattening
    order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {key: build(t[key]) for key in sorted(t)}
            return {key: built[key] for key in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(sub) for sub in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn: Callable, tree, *rest):
    """fn(leaf, *leaves at the same place in `rest`) over every leaf;
    the trees in `rest` may hold more below a leaf of `tree` (taken
    whole)."""
    flat = leaves(tree)
    others = [flatten_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in zip(flat, *others)])


def flatten_up_to(shape_tree, tree) -> list:
    """The subtrees of `tree` at the leaves of `shape_tree`, in order (the
    reference's ``treedef.flatten_up_to``)."""
    if shape_tree is None:
        return []
    if isinstance(shape_tree, dict):
        out = []
        for key in sorted(shape_tree):
            out += flatten_up_to(shape_tree[key], tree[key])
        return out
    if isinstance(shape_tree, (list, tuple)):
        out = []
        for sub, t in zip(shape_tree, tree):
            out += flatten_up_to(sub, t)
        return out
    return [tree]
