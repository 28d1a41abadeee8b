"""Checkpoint save/load, in the JAX package's file format.

Counterpart of fastenhancer_tpu/train/checkpoint.py: one pickle per epoch
at `{base_dir}/{epoch:05d}.ckpt`, written through a `.tmp` file and an
atomic rename, holding {"variables", "opt_state", "scheduler", "epoch",
"metrics"}. Every array is a numpy array on the host at its JAX tree
path (tensors are moved off the device first), so the pickle holds no
torch object: a checkpoint written by either package resumes in the other
(`wrappers/ns.py::ModelWrapper.save` / `load`). `opt_state` is
`GroupedOptimizer.state_tree`'s {"m", "v", "step"}.
"""
from __future__ import annotations

import os
import pickle
import re
import typing as tp

import numpy as np
import torch

_CKPT_RE = re.compile(r"^([0-9]{5,})\.ckpt$")


def _to_host(tree: tp.Any) -> tp.Any:
    """Tensors and arrays -> numpy arrays (bfloat16 widened to float32:
    numpy has none); containers, None and Python scalars kept."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    if isinstance(tree, np.ndarray) or hasattr(tree, "dtype"):
        return np.asarray(tree)
    return tree


def save_checkpoint(
    base_dir: str,
    epoch: int,
    state: tp.Dict[str, tp.Any],
    scheduler_state: tp.Any = None,
    metrics: tp.Any = None,
) -> str:
    os.makedirs(base_dir, exist_ok=True)
    path = os.path.join(base_dir, f"{epoch:05d}.ckpt")
    payload = {
        "variables": _to_host(state["variables"]),
        "opt_state": _to_host(state.get("opt_state")),
        "scheduler": scheduler_state,
        "epoch": epoch,
        "metrics": metrics,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic: no torn checkpoints on preemption
    return path


def latest_checkpoint(base_dir: str) -> tp.Optional[str]:
    """Numerically-latest NNNNN.ckpt in base_dir."""
    if not os.path.isdir(base_dir):
        return None
    best: tp.Tuple[int, tp.Optional[str]] = (-1, None)
    for name in os.listdir(base_dir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best[0]:
            best = (int(m.group(1)), name)
    return os.path.join(base_dir, best[1]) if best[1] else None


def load_checkpoint(path: str) -> tp.Dict[str, tp.Any]:
    """Unpickle a checkpoint: only load files this program (or the JAX
    package) wrote; unpickling runs code."""
    with open(path, "rb") as f:
        return pickle.load(f)


def clean_checkpoints(base_dir: str, keep_last: int = 1) -> tp.List[str]:
    """Remove all but the newest `keep_last` checkpoints. Returns removed
    paths."""
    if not os.path.isdir(base_dir):
        return []
    ckpts = sorted(
        (int(m.group(1)), name)
        for name in os.listdir(base_dir)
        if (m := _CKPT_RE.match(name))
    )
    removed = []
    for _, name in ckpts[:-keep_last] if keep_last else ckpts:
        path = os.path.join(base_dir, name)
        os.remove(path)
        removed.append(path)
    return removed
