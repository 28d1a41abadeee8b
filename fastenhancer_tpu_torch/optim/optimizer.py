"""Regex parameter groups and the grouped AdamP/AdamW/Adam optimizer.

Counterpart of fastenhancer_tpu/optim/optimizer.py. The reference
partitions torch's named_parameters into optimizer groups with the regex
lists of `train.optimizer_groups` (so that, for example, weight-norm `g`
tensors get `projection: disabled`). Each model maps its param-tree paths
to the reference's parameter names (`Model.torch_name`), the same
successive bipartition runs on those names, and every group, empty ones
included, keeps its index, so a scheduler's per-group learning rates line
up with the JAX package's.

Frozen leaves (the reference's buffers: fixed filterbanks, a fixed
positional embedding) are in no group and are never updated.
"""
from __future__ import annotations

import re
import typing as tp

import numpy as np
import torch

from ..utils.tree import tree_paths
from .adamp import adam_leaf_update, adamp_leaf_update, adamw_leaf_update

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]
PathKey = tp.Tuple[str, ...]

_LEAF_UPDATES = {
    "AdamP": adamp_leaf_update,
    "AdamW": adamw_leaf_update,
    "Adam": adam_leaf_update,
}


def path_key(path: tp.Sequence[tp.Any]) -> PathKey:
    """A tree path (dict keys and list indices) as a tuple of strings,
    ('rf_blocks', '0', 'rnn', ...)."""
    return tuple(str(p) for p in path)


def named_parameters(params: Params,
                     torch_name: tp.Callable[[PathKey], tp.Optional[str]],
                     frozen: tp.Iterable[PathKey] = ()
                     ) -> tp.Dict[str, PathKey]:
    """Reference-style name -> leaf path of every trainable leaf;
    `torch_name` may return None to mark a leaf as a buffer."""
    frozen = {path_key(f) for f in frozen}
    out: tp.Dict[str, PathKey] = {}
    for path, _ in tree_paths(params):
        if path in frozen:
            continue
        name = torch_name(path)
        if name is not None:
            out[name] = path
    return out


def partition_param_groups(
    named: tp.Dict[str, PathKey],
    optimizer_kwargs: tp.Dict[str, tp.Any],
    optimizer_groups: tp.Optional[tp.Sequence[tp.Mapping[str, tp.Any]]],
) -> tp.Tuple[tp.Dict[PathKey, int], tp.List[tp.Dict[str, tp.Any]]]:
    """The reference's successive regex bipartition: each optimizer_groups
    entry splits every existing group into (no match, match + overrides).
    Returns (leaf path -> group index, each group's merged kwargs)."""
    groups: tp.List[tp.Tuple[tp.Dict[str, PathKey], tp.Dict[str, tp.Any]]] = [
        (dict(named), dict(optimizer_kwargs))]
    for hp in optimizer_groups or []:
        hp = dict(hp)
        regex_list = hp.pop("regex_list")
        new_groups = []
        for members, kwargs in groups:
            miss: tp.Dict[str, PathKey] = {}
            hit: tp.Dict[str, PathKey] = {}
            for name, path in members.items():
                if any(re.search(rx, name) for rx in regex_list):
                    hit[name] = path
                else:
                    miss[name] = path
            new_groups.append((miss, kwargs))
            new_groups.append((hit, {**kwargs, **hp}))
        groups = new_groups

    assignment: tp.Dict[PathKey, int] = {}
    group_kwargs: tp.List[tp.Dict[str, tp.Any]] = []
    for members, kwargs in groups:
        gid = len(group_kwargs)
        group_kwargs.append(kwargs)
        for path in members.values():
            assignment[path] = gid
    return assignment, group_kwargs


def _normalize_kwargs(kw: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """Config kwargs -> the leaf update's: betas split into beta1/beta2, lr
    dropped (it comes from the schedule), a digit string projection as an
    int dim."""
    out = dict(kw)
    betas = out.pop("betas", None)
    if betas is not None:
        out["beta1"], out["beta2"] = float(betas[0]), float(betas[1])
    out.pop("lr", None)
    proj = out.get("projection")
    if isinstance(proj, str) and proj.isdigit():
        out["projection"] = int(proj)
    return out


class GroupedOptimizer(torch.optim.Optimizer):
    """AdamP, AdamW or Adam over the leaves of a param tree, one
    `param_group` per regex group, each carrying its update kwargs
    ("hparams"), its leaf paths ("paths") and its learning rate ("lr",
    which the scheduler sets). A leaf's state is {"m", "v", "step"}.
    `step()` updates the leaves in place, in float32.

    `state_tree` / `load_state_tree` move the state to and from the JAX
    package's layout ({"m", "v", "step"}; see `state_tree`), the optimizer
    half of a checkpoint."""

    def __init__(self, name: str, params: Params,
                 assignment: tp.Dict[PathKey, int],
                 group_kwargs: tp.Sequence[tp.Mapping[str, tp.Any]]):
        if name not in _LEAF_UPDATES:
            raise ValueError(f"unsupported optimizer {name!r} "
                             f"(supported: {sorted(_LEAF_UPDATES)})")
        self.name = name
        self.base_lrs = [float(kw.get("lr", 0.0)) for kw in group_kwargs]
        leaves = dict(tree_paths(params))
        groups = []
        for gid, kw in enumerate(group_kwargs):
            paths = [p for p, g in assignment.items() if g == gid]
            groups.append({"params": [leaves[p] for p in paths],
                           "paths": paths, "lr": self.base_lrs[gid],
                           "hparams": _normalize_kwargs(kw)})
        super().__init__(groups, defaults={})

    @property
    def n_groups(self) -> int:
        return len(self.param_groups)

    def set_lrs(self, lrs: tp.Sequence[float]) -> None:
        """Each group's learning rate, in group order."""
        for group, lr in zip(self.param_groups, lrs, strict=True):
            group["lr"] = float(lr)

    @torch.no_grad()
    def step(self, closure: tp.Optional[tp.Callable[[], Tensor]] = None
             ) -> None:
        """One update of every trainable leaf; a leaf without a gradient
        is stepped with a zero one, as every leaf is in the JAX package."""
        if closure is not None:
            raise ValueError("GroupedOptimizer.step takes no closure")
        update = _LEAF_UPDATES[self.name]
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p, dtype=torch.float32)
                    st["v"] = torch.zeros_like(p, dtype=torch.float32)
                    st["step"] = torch.zeros((), dtype=torch.int32,
                                             device=p.device)
                st["step"] += 1
                g = (torch.zeros_like(p) if p.grad is None else p.grad)
                lr = torch.tensor(group["lr"], dtype=torch.float32,
                                  device=p.device)
                new_p, st["m"], st["v"] = update(
                    p.float(), g.float(), st["m"], st["v"], st["step"], lr,
                    **group["hparams"])
                p.copy_(new_p)

    def state_tree(self, params: Params) -> Params:
        """The state as JAX's `GroupedOptimizer.init` lays it out: {"m":
        tree, "v": tree, "step": int32 scalar}, the trees at `params`'s
        paths with None at frozen leaves, every leaf a numpy array on the
        host. Before the first step the moments are zeros and the step 0.
        The port counts steps per leaf; every trained leaf is stepped
        together, so they agree and the one counter is theirs."""
        moments: tp.Dict[PathKey, tp.Tuple[np.ndarray, np.ndarray]] = {}
        steps = set()
        for group in self.param_groups:
            for path, p in zip(group["paths"], group["params"]):
                st = self.state.get(p)
                if st:
                    moments[path] = (st["m"].cpu().numpy().copy(),
                                     st["v"].cpu().numpy().copy())
                    steps.add(int(st["step"]))
                else:
                    zeros = np.zeros(tuple(p.shape), np.float32)
                    moments[path] = (zeros, zeros.copy())
                    steps.add(0)
        if len(steps) > 1:
            raise RuntimeError(f"the leaves' step counts differ: {steps}")
        return {"m": _map_paths(params, moments, 0),
                "v": _map_paths(params, moments, 1),
                "step": np.asarray(steps.pop() if steps else 0, np.int32)}

    @torch.no_grad()
    def load_state_tree(self, opt_state: Params) -> None:
        """Set every trained leaf's m, v and step from a `state_tree`-
        layout state (numpy or tensor leaves), on the leaf's device. The
        params themselves are not touched."""
        m = dict(tree_paths(opt_state["m"]))
        v = dict(tree_paths(opt_state["v"]))
        step = int(np.asarray(opt_state["step"]))
        for group in self.param_groups:
            for path, p in zip(group["paths"], group["params"]):
                if path not in m or path not in v:
                    raise KeyError(f"optimizer state has no moments at "
                                   f"{'.'.join(path)}")
                st = self.state[p]
                for key, tree in (("m", m), ("v", v)):
                    a = torch.from_numpy(np.array(tree[path]))
                    if tuple(a.shape) != tuple(p.shape):
                        raise ValueError(
                            f"optimizer state {key} at {'.'.join(path)}: "
                            f"shape {tuple(a.shape)} != {tuple(p.shape)}")
                    st[key] = a.to(device=p.device, dtype=torch.float32,
                                   copy=True)
                st["step"] = torch.tensor(step, dtype=torch.int32,
                                          device=p.device)


def _map_paths(tree: tp.Any, values: tp.Dict[PathKey, tp.Any], index: int,
               prefix: PathKey = ()) -> tp.Any:
    """`tree`'s shape with values[path][index] at each path in `values`
    and None elsewhere."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, values, index, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(v, values, index, prefix + (str(i),))
                for i, v in enumerate(tree)]
    return values[prefix][index] if prefix in values else None
