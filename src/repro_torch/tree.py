"""Nested-dict trees: the port's counterpart of ``jax.tree`` for the
training state (``{"params": ..., "opt": ..., "step": ...}``).

A tree is a dict whose values are trees or leaves; anything that is not
a dict is a leaf. Leaves are visited in sorted key order, as
``jax.tree`` flattens a dict, so a sum over leaves adds in ``repro``'s
order and a leaf's path (``"opt/mu/w0"``) is the name ``repro``'s
checkpoints give it.
"""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    each tree in ``rest`` (which have ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` in sorted key order, paths joined by
    ``/``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix
                                  else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten_paths(items) -> dict:
    """The nested dict of ``(path, leaf)`` pairs (the inverse of
    ``flatten_with_paths`` for a dict tree)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out
