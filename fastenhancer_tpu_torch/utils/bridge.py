"""Weight bridge between the JAX package's variables and the port's.

`fastenhancer_tpu/utils/convert.py` maps a reference torch state_dict into
the JAX tree. This module moves that tree itself across: the JAX
{"params", "stats"} tree, with numpy leaves (or anything `np.asarray`
takes), becomes the port's tree of tensors with every leaf at the same path.
Weight-norm {"g", "v"} leaves stay dicts, and the None entries and empty
stats dicts of folded trees are kept. Nothing here imports jax.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .tree import tree_map


def from_jax(tree: tp.Any, device: torch.device) -> tp.Any:
    """JAX-package variables (numpy leaves) -> the port's variables on
    `device`. Leaves are copied, so later edits on either side stay apart;
    bfloat16 leaves (ml_dtypes) stay bfloat16."""
    def leaf(a: tp.Any) -> torch.Tensor:
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(a).to(device)

    return tree_map(leaf, tree)


def to_numpy(variables: tp.Any) -> tp.Any:
    """The port's variables -> a tree of numpy arrays at the same paths
    (bfloat16 leaves widen to float32: numpy has no bfloat16)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    return tree_map(leaf, variables)
