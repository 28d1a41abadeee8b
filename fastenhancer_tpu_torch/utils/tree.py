"""Parameter trees: nested dicts and lists whose leaves are tensors or None.

The port keeps the JAX package's {"params", "stats"} tree shape, so a leaf
has the same path in both packages. These helpers stand in for jax.tree.
"""
from __future__ import annotations

import typing as tp

import torch


def tree_map(fn: tp.Callable[[tp.Any], tp.Any], tree: tp.Any) -> tp.Any:
    """Apply `fn` to every non-None leaf; dicts and lists/tuples are
    containers (a tuple comes back as a list)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree: tp.Any) -> tp.List[tp.Any]:
    """Non-None leaves in insertion order (dict keys as stored)."""
    out: tp.List[tp.Any] = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree: tp.Any, prefix: tp.Tuple[str, ...] = ()
               ) -> tp.List[tp.Tuple[tp.Tuple[str, ...], tp.Any]]:
    """(path, leaf) of every non-None leaf in insertion order; a path is a
    tuple of dict keys and list indices as strings, ("rf_blocks", "0",
    "rnn", ...), as the JAX package's `path_key` writes them."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(tree_paths(v, prefix + (k,)))
    return out


def cast_floating(tree: tp.Any, dtype: torch.dtype) -> tp.Any:
    """Cast every floating-point tensor leaf to `dtype`."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)
