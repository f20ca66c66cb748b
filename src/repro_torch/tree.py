"""Trees of tensors: the few `jax.tree_util` functions the training path
uses, over the containers the port's trees are made of.

A tree is a tensor (or any other leaf), a dict, a tuple or list, or a
NamedTuple; None is an empty subtree.  Leaves come in `jax.tree_util`'s
order (a dict's keys sorted, sequences and NamedTuple fields in order), and
`flatten_with_path` names each leaf as `jax.tree_util.keystr` spells its
path (``['embed']``, ``[0]``, ``.m``), so a checkpoint's leaf names are the
reference's.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list:
    """(path piece, child) pairs of one container, in the reference's order;
    None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def flatten_with_path(tree, prefix: str = "") -> list:
    """[(path, leaf)] in leaf order, paths spelled as `keystr` does."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for piece, c in kids for pair in flatten_with_path(c, prefix + piece)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` whose leaves are ``new_leaves``, taken in
    leaf order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}              # the template's key order
        if _is_namedtuple(t):
            return type(t)(*(build(c) for c in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(c) for c in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template has")
    return out


def map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    others = [leaves(r) for r in rest]
    own = leaves(tree)
    if any(len(o) != len(own) for o in others):
        raise ValueError("tree.map: the trees differ in structure")
    return unflatten(tree, [fn(*args) for args in zip(own, *others)])
