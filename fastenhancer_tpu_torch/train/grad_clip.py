"""Gradient clipping over trees of gradients (dicts and lists of tensors).

Counterpart of fastenhancer_tpu/train/grad_clip.py. Modes, chosen by
`train.clip_grad`:
  "norm" / "norm_global" - clip by the global L2 norm (torch clip_grad_norm_);
  "norm_local"           - clip each tensor by its own norm;
  "value"                - clamp each element (torch clip_grad_value_).
Every clipper returns (clipped grads, global norm of the unclipped grads).
"""
from __future__ import annotations

import typing as tp

import torch

from ..utils.tree import tree_leaves, tree_map

Tensor = torch.Tensor


def global_norm(tree: tp.Any) -> Tensor:
    return torch.stack([g.square().sum() for g in tree_leaves(tree)]
                       ).sum().sqrt()


def clip_grad_norm(grads: tp.Any, max_norm: float, eps: float = 1e-6
                   ) -> tp.Tuple[tp.Any, Tensor]:
    norm = global_norm(grads)
    scale = (max_norm / (norm + eps)).clamp_max(1.0)
    return tree_map(lambda g: g * scale, grads), norm


def clip_grad_norm_local(grads: tp.Any, max_norm: float, eps: float = 1e-6
                         ) -> tp.Tuple[tp.Any, Tensor]:
    def clip_one(g: Tensor) -> Tensor:
        n = g.square().sum().sqrt()
        return g * (max_norm / (n + eps)).clamp_max(1.0)
    return tree_map(clip_one, grads), global_norm(grads)


def clip_grad_value(grads: tp.Any, clip_value: float
                    ) -> tp.Tuple[tp.Any, Tensor]:
    return (tree_map(lambda g: g.clamp(-clip_value, clip_value), grads),
            global_norm(grads))


def make_clipper(mode: tp.Optional[str],
                 kwargs: tp.Optional[tp.Mapping[str, tp.Any]] = None
                 ) -> tp.Callable[[tp.Any], tp.Tuple[tp.Any, Tensor]]:
    """fn(grads) -> (clipped grads, global norm)."""
    kwargs = dict(kwargs or {})
    if mode is None:
        return lambda g: (g, global_norm(g))
    if mode in ("norm", "norm_global"):
        return lambda g: clip_grad_norm(g, **kwargs)
    if mode == "norm_local":
        return lambda g: clip_grad_norm_local(g, **kwargs)
    if mode == "value":
        return lambda g: clip_grad_value(g, **kwargs)
    raise ValueError(f"unsupported clip_grad mode {mode!r}")
