"""Step-window trace capture on `torch.profiler`.

Counterpart of fastenhancer_tpu/utils/profiler.py: one trace of a small
window of train steps, which skips warmup and stops by itself, so the rest
of the run pays nothing. Enable it per run in the config's train section,
`profile: true` (steps 10-15) or `profile: {start: 20, steps: 5}`; a
config that has the key takes a CLI override as well:

    python -m fastenhancer_tpu_torch.train ... \
        -p 'train.profile={"start": 20, "steps": 5}'

The trace is `torch.profiler`'s Chrome trace (where the JAX package writes
XLA's), `{logdir}/<host>_<pid>.<ms>.pt.trace.json`, logdir
`{base_dir}/profile/` unless `train.profile` names one; Perfetto or
chrome://tracing open it. Its activities are the CPU's and, on a card,
CUDA's: the card's kernels are events of category "kernel". Under several
ranks every rank traces its own window into the same logdir, one file per
process, as each JAX process does.
"""
from __future__ import annotations

import os
import socket
import time
import typing as tp

import torch

__all__ = ["StepProfiler", "make_profiler"]


class StepProfiler:
    """Capture one trace of the window [start, start + steps) of `step()`
    calls, as the JAX package counts it.

    Call `step()` once per train step, after the step's dispatch: call
    number `start` (from 0) opens the trace and call `start + steps - 1`
    closes it, so the trace holds the `steps - 1` steps dispatched in
    between (numbers start + 1 .. start + steps - 1). On a card both edges
    synchronise it first, so the trace holds those steps' kernels and no
    other step's (XLA's trace also catches the step in flight at the
    opening).
    """

    def __init__(self, logdir: str, start: int = 10, steps: int = 5,
                 cuda: bool = False):
        self.logdir = logdir
        self.start = int(start)
        self.stop = int(start) + int(steps)
        self.cuda = cuda
        self.trace_path: tp.Optional[str] = None
        self._idx = 0
        self._prof: tp.Optional[torch.profiler.profile] = None
        self.done = False

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self) -> None:
        """Advance the step counter; open or close the trace at the window
        edges."""
        if self.done:
            return
        if self._idx == self.start and not self.active:
            self._open()
        self._idx += 1
        if self.active and self._idx >= self.stop:
            self.close()

    def _open(self) -> None:
        os.makedirs(self.logdir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def close(self) -> None:
        """Stop an open trace (an epoch may end inside the window) and write
        it; one window per run either way."""
        if self.active:
            if self.cuda:
                torch.cuda.synchronize()
            self._prof.stop()
            self.trace_path = os.path.join(
                self.logdir, f"{socket.gethostname()}_{os.getpid()}."
                             f"{int(time.time() * 1000)}.pt.trace.json")
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
            self.done = True
        if self._idx >= self.stop:
            self.done = True


def make_profiler(hp_train: tp.Any, base_dir: str,
                  device: tp.Union[str, torch.device, None] = None
                  ) -> tp.Optional[StepProfiler]:
    """A StepProfiler from `train.profile` (False | True | {start, steps,
    logdir}); its trace holds CUDA activity when `device` is a card."""
    spec = hp_train.get("profile", False)
    if not spec:
        return None
    kwargs: tp.Dict[str, tp.Any] = {}
    if hasattr(spec, "to_dict"):
        kwargs = spec.to_dict()
    elif isinstance(spec, dict):
        kwargs = dict(spec)
    logdir = kwargs.pop("logdir", os.path.join(base_dir, "profile"))
    cuda = device is not None and torch.device(device).type == "cuda"
    return StepProfiler(logdir, cuda=cuda, **kwargs)
