"""Nested trees of parameters and optimizer state: the port's counterpart
of the pytrees the JAX package flattens with ``jax.tree_util``.

A tree is a dict, list or tuple of subtrees, or a leaf (a tensor, an int or
a float).  An ``nn.Module`` stands for the dict of its
``named_parameters()``.  Leaves come in a fixed order: dicts in insertion
order (the port builds every tree in one fixed order, so the names need no
sorting), lists and tuples by index, a module in registration order.  Each
leaf is named by its key path joined with dots (``blocks.3.attn.wq``).
"""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple

from torch import nn


def named_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key path, leaf), ...]`` in the tree's fixed order."""
    if isinstance(tree, nn.Module):
        return [(prefix + name, p) for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix[:-1], tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out += named_leaves(sub, f"{prefix}{key}.")
    return out


def jax_stacks(tree: Any) -> List[int]:
    """For each leaf, in order, the index of the array of JAX's tree that
    holds it: JAX stacks an LM's layers on a leading axis, one array a
    weight, where the port keeps them in an ``nn.ModuleList``, so the
    leaves of every layer that differ only in their index in a
    ``ModuleList`` share one; in a dict tree each leaf is its own."""
    if not isinstance(tree, nn.Module):
        return list(range(len(named_leaves(tree))))
    lists = {name for name, m in tree.named_modules()
             if isinstance(m, nn.ModuleList)}
    keys: dict = {}
    out = []
    for name, _ in tree.named_parameters():
        parts = name.split(".")
        key = [p for i, p in enumerate(parts)
               if not (p.isdigit() and ".".join(parts[:i]) in lists)]
        out.append(keys.setdefault(".".join(key), len(keys)))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]


def unflatten(like: Any, new_leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves, in order, taken from
    ``new_leaves``; a module becomes the dict of its parameters' names."""
    if isinstance(like, nn.Module):
        return {name: next(new_leaves) for name, _ in like.named_parameters()}
    if isinstance(like, dict):
        return {k: unflatten(v, new_leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(v, new_leaves) for v in like)
    return next(new_leaves)
