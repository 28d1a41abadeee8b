"""Host-side learning-rate schedulers, plain Python.

A copy of fastenhancer_tpu/optim/lr_scheduler.py (the port imports nothing
of the JAX package), with the reference's semantics. `lrs` holds the
current per-group learning rates, which the train step hands to the
optimizer each iteration. Contract:
  * `warmup_step()` after every optimizer step (only CosineAnnealingWarmup
    does anything with it),
  * `step()` (or `step(metric)` for ReduceLROnPlateau) at the end of each
    epoch.
"""
from __future__ import annotations

import math
import typing as tp


class Scheduler:
    """Base: fixed LRs."""

    # True for schedulers whose per-epoch step() consumes a validation
    # metric (ReduceLROnPlateau); the wrapper then defers the step to the
    # end of valid_epoch and passes the total valid loss
    requires_metric: bool = False

    def __init__(self, base_lrs: tp.Sequence[float]):
        self.base_lrs = list(base_lrs)
        self.lrs = list(base_lrs)
        self.last_epoch = 0

    def warmup_step(self) -> None:
        pass

    def step(self, metric: tp.Optional[float] = None) -> None:
        self.last_epoch += 1

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {k: v for k, v in self.__dict__.items()}

    def load_state_dict(self, sd: tp.Optional[tp.Dict[str, tp.Any]]) -> None:
        if sd:
            self.__dict__.update(sd)


class EmptyScheduler(Scheduler):
    """reference: optim/lr_scheduler.py:12-24."""

    def state_dict(self):
        return None

    def load_state_dict(self, sd):
        if sd is not None:
            raise KeyError("Tried to load a non-empty scheduler into EmptyScheduler")


class CosineAnnealingLR(Scheduler):
    def __init__(self, base_lrs, T_max: int, eta_min: float = 0.0):
        super().__init__(base_lrs)
        self.T_max = T_max
        self.eta_min = eta_min

    def step(self, metric=None):
        self.last_epoch += 1
        self.lrs = [
            self.eta_min
            + (b - self.eta_min) * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
            for b in self.base_lrs
        ]


class CosineAnnealingWarmup(Scheduler):
    """Per-iteration linear warmup + per-epoch cosine decay.

    reference: optim/lr_scheduler.py:296-357 — including the quirk that if the
    warmup outlasts the first epoch, `step()` freezes the epoch counter and
    decrements T_max instead.
    """

    def __init__(self, base_lrs, warmup_iterations: int, T_max: float,
                 eta_min: float = 0.0, warn: bool = True):
        super().__init__(base_lrs)
        self.warmup_iterations = warmup_iterations
        self.T_max = T_max
        self.eta_min = eta_min
        self.warn = warn
        self.current_iteration = 1
        self.lrs = self._get_lrs()

    def _get_lrs(self) -> tp.List[float]:
        if self.current_iteration <= self.warmup_iterations:
            scale = self.current_iteration / self.warmup_iterations
            return [b * scale for b in self.base_lrs]
        return [
            self.eta_min
            + (b - self.eta_min) * (1 + math.cos(self.last_epoch * math.pi / self.T_max)) / 2
            for b in self.base_lrs
        ]

    def warmup_step(self) -> None:
        if self.current_iteration > self.warmup_iterations:
            return
        scale = self.current_iteration / self.warmup_iterations
        self.lrs = [b * scale for b in self.base_lrs]
        self.current_iteration += 1

    def step(self, metric=None) -> None:
        if self.current_iteration > self.warmup_iterations:
            self.last_epoch += 1
            self.lrs = self._get_lrs()
            return
        # warmup longer than one epoch: hold the cosine clock, shrink T_max
        self.T_max -= 1


class CosineAnnealingWarmupRestarts(Scheduler):
    """SGDR-style warm restarts with linear warmup each cycle.

    reference: optim/lr_scheduler.py:27-115. All groups share max_lr.
    """

    def __init__(self, base_lrs, first_cycle_steps: int, max_lr: float,
                 cycle_mult: float = 1.0, min_lr: float = 1e-4,
                 initial_lr: tp.Optional[float] = None, warmup_steps: int = 0,
                 gamma: float = 1.0):
        assert warmup_steps < first_cycle_steps
        init = initial_lr if initial_lr is not None else min_lr
        super().__init__([init] * len(base_lrs))
        self.first_cycle_steps = first_cycle_steps
        self.cycle_mult = cycle_mult
        self.base_max_lr = max_lr
        self.max_lr = max_lr
        self.min_lr = min_lr
        self.warmup_steps = warmup_steps
        self.gamma = gamma
        self.cur_cycle_steps = first_cycle_steps
        self.cycle = 0
        self.step_in_cycle = -1
        self.lrs = list(self.base_lrs)

    def _get_lrs(self) -> tp.List[float]:
        if self.step_in_cycle == -1:
            return list(self.base_lrs)
        if self.step_in_cycle < self.warmup_steps:
            return [
                (self.max_lr - b) * self.step_in_cycle / self.warmup_steps + b
                for b in self.base_lrs
            ]
        frac = (self.step_in_cycle - self.warmup_steps) / (
            self.cur_cycle_steps - self.warmup_steps)
        lr = self.min_lr + (self.max_lr - self.min_lr) * (1 + math.cos(math.pi * frac)) / 2
        return [lr for _ in self.base_lrs]

    def step(self, metric=None) -> None:
        self.last_epoch += 1
        self.step_in_cycle += 1
        if self.step_in_cycle >= self.cur_cycle_steps:
            self.cycle += 1
            self.step_in_cycle -= self.cur_cycle_steps
            self.cur_cycle_steps = (
                int((self.cur_cycle_steps - self.warmup_steps) * self.cycle_mult)
                + self.warmup_steps
            )
        self.max_lr = self.base_max_lr * (self.gamma ** self.cycle)
        self.lrs = self._get_lrs()


class ReduceLROnPlateau(Scheduler):
    """Plateau scheduler with the reference's `initial_patience` patch
    (reference: optim/lr_scheduler.py:118-293)."""

    requires_metric = True

    def __init__(self, base_lrs, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, initial_patience: int = 0,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: tp.Union[float, tp.Sequence[float]] = 0.0,
                 eps: float = 1e-8):
        if factor >= 1.0:
            raise ValueError("Factor should be < 1.0.")
        super().__init__(base_lrs)
        if isinstance(min_lr, (list, tuple)):
            assert len(min_lr) == len(self.base_lrs)
            self.min_lrs = list(min_lr)
        else:
            self.min_lrs = [min_lr] * len(self.base_lrs)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.initial_patience = initial_patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.eps = eps
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        if self.mode == "min":
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric: tp.Optional[float] = None) -> None:
        assert metric is not None, "ReduceLROnPlateau.step requires a metric"
        current = float(metric)
        self.last_epoch += 1
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.last_epoch <= self.initial_patience:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lrs = []
            for old, mn in zip(self.lrs, self.min_lrs):
                new = max(old * self.factor, mn)
                new_lrs.append(new if old - new > self.eps else old)
            self.lrs = new_lrs
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
