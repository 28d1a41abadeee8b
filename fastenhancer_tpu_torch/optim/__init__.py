"""Optimizer and scheduler factories.

Counterpart of fastenhancer_tpu/optim/__init__.py. `get_optimizer(model,
params, hp_train)` runs the regex param-group partition over the
reference's parameter names (`model.torch_name`) and returns a
`GroupedOptimizer` over the tree's leaves; `get_scheduler(optimizer,
hp_train)` returns the host-side schedule whose `lrs` feed each step.
`hp_train` is the config's `train` section as a dict.
"""
from __future__ import annotations

import typing as tp

from . import lr_scheduler
from .adamp import adam_leaf_update, adamp_leaf_update, adamw_leaf_update
from .lr_scheduler import (
    CosineAnnealingLR,
    CosineAnnealingWarmup,
    CosineAnnealingWarmupRestarts,
    EmptyScheduler,
    ReduceLROnPlateau,
    Scheduler,
)
from .optimizer import (
    GroupedOptimizer,
    named_parameters,
    partition_param_groups,
    path_key,
)


def get_optimizer(model, params, hp_train: tp.Mapping[str, tp.Any]
                  ) -> GroupedOptimizer:
    """model exposes torch_name(path) and fixed_param_paths(); `params` is
    the params subtree (not the variables)."""
    named = named_parameters(params, model.torch_name,
                             model.fixed_param_paths())
    assignment, group_kwargs = partition_param_groups(
        named, dict(hp_train.get("optimizer_kwargs") or {}),
        hp_train.get("optimizer_groups"))
    return GroupedOptimizer(hp_train["optimizer"], params, assignment,
                            group_kwargs)


def get_scheduler(optimizer: GroupedOptimizer,
                  hp_train: tp.Mapping[str, tp.Any]) -> Scheduler:
    name = hp_train.get("scheduler")
    kwargs = dict(hp_train.get("scheduler_kwargs") or {})
    base_lrs = optimizer.base_lrs
    if name is None or name == "EmptyScheduler":
        return EmptyScheduler(base_lrs)
    if name in ("CosineAnnealingLR", "CosineAnnealingWarmup"):
        kwargs.setdefault("T_max", hp_train.get("max_epochs"))
        cls = (CosineAnnealingLR if name == "CosineAnnealingLR"
               else CosineAnnealingWarmup)
        return cls(base_lrs, **kwargs)
    if name == "CosineAnnealingWarmupRestarts":
        kwargs.setdefault("max_lr",
                          (hp_train.get("optimizer_kwargs") or {}).get("lr"))
        return CosineAnnealingWarmupRestarts(base_lrs, **kwargs)
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(base_lrs, **kwargs)
    raise ValueError(f"unsupported scheduler {name!r}")


__all__ = [
    "GroupedOptimizer", "named_parameters", "partition_param_groups",
    "path_key", "get_optimizer", "get_scheduler", "lr_scheduler",
    "Scheduler", "EmptyScheduler", "CosineAnnealingLR",
    "CosineAnnealingWarmup", "CosineAnnealingWarmupRestarts",
    "ReduceLROnPlateau", "adamp_leaf_update", "adamw_leaf_update",
    "adam_leaf_update",
]
