"""Noise-suppression training wrapper on one device.

Counterpart of the single-device part of fastenhancer_tpu/wrappers/ns.py.
`ModelWrapper(hps, train=...)` builds, from a config dict (the YAML's
sections as plain dicts, e.g. `presets.FE_T_SHARD`), the model and its
variables, and with train=True the losses, the optimizer, the scheduler
and the train and valid steps. `train_epoch` and `valid_epoch` run over any
iterable of {"clean", "noisy"} numpy batches.

Not ported yet: several devices and hosts, TensorBoard summaries, the
profiler, PESQ/STOI evaluation, checkpoints, and the dataloaders built from
directories (ROADMAP queue 1, "Training, end to end on one card").
"""
from __future__ import annotations

import copy
import typing as tp

import numpy as np
import torch

from .. import require_cuda
from ..losses import Losses
from ..models import get_model
from ..optim import get_optimizer, get_scheduler
from ..train import make_train_step, make_valid_step

Tensor = torch.Tensor


class ModelWrapper:
    def __init__(self, hps: tp.Mapping[str, tp.Any], train: bool = False,
                 device: tp.Union[str, torch.device, None] = None):
        """device: the card (`require_cuda()`) unless the caller names
        another, as the CPU tests do with device="cpu"."""
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.model = get_model(hps["model"], **hps["model_kwargs"])
        self.sr: int = hps["data"]["sampling_rate"]
        self.hop_size: int = self.model.hop_size
        hp = hps.get("train", {})
        self.seed = hp.get("seed", 0)
        variables = self.model.init(
            torch.Generator().manual_seed(self.seed), self.device)
        self.state: tp.Dict[str, tp.Any] = {"variables": variables}
        self.scheduler = None
        self.test = False
        if not train:
            return
        self.test = hp.get("test", False)
        # fp16: True in the reference configs means bfloat16 compute over
        # float32 masters here, as in the JAX package (no gradient scaler)
        use_mixed = hp.get("fp16", False) or hp.get("bf16", False)
        self.compute_dtype = torch.bfloat16 if use_mixed else None
        self.model.remat = bool(hp.get("remat", False))
        losses_cfg = copy.deepcopy(dict(hp["losses"]))
        if "consistency" in losses_cfg:
            mk = hps["model_kwargs"]
            losses_cfg["consistency"].update(
                n_fft=mk["n_fft"], hop_size=mk["hop_size"],
                win_size=mk.get("win_size"), win_type=mk.get("window"))
        self.loss = Losses(losses_cfg)
        self.optim = get_optimizer(self.model, variables["params"], hp)
        self.scheduler = get_scheduler(self.optim, hp)
        self.train_step = make_train_step(
            self.model, self.loss, self.optim,
            clip_grad=hp.get("clip_grad"),
            clip_grad_kwargs=hp.get("clip_grad_kwargs"),
            compute_dtype=self.compute_dtype,
            skip_nonfinite=hp.get("skip_nonfinite_grads", False))
        self.valid_step = make_valid_step(self.model, self.loss,
                                          self.compute_dtype)

    def get_lr(self) -> float:
        return self.scheduler.lrs[0] if self.scheduler else 0.0

    def _lrs(self) -> tp.List[float]:
        return list(self.scheduler.lrs)

    def _device_batch(self, batch: tp.Mapping[str, np.ndarray],
                      keys: tp.Sequence[str]
                      ) -> tp.Tuple[tp.Dict[str, Tensor], int]:
        """The batch's `keys` cut to a multiple of the hop and moved to the
        device, with "row_mask" [B] of ones (every row is real on one
        device); returns (batch, rows)."""
        arrs = {k: np.asarray(batch[k]) for k in keys if k in batch}
        b = next(iter(arrs.values())).shape[0]
        t = min(a.shape[-1] for a in arrs.values()) // self.hop_size
        out = {k: torch.from_numpy(np.ascontiguousarray(
            a[..., :t * self.hop_size], dtype=np.float32)).to(self.device)
            for k, a in arrs.items()}
        out["row_mask"] = torch.ones(b, device=self.device)
        return out, b

    def _step_and_account(self, dev_batch: tp.Dict[str, Tensor],
                          rows: int) -> tp.Dict[str, Tensor]:
        """One train step, its losses added to the epoch's running sums
        (on the device: the loop does not wait for the card), then the
        warmup step of the schedule."""
        self.state, metrics = self.train_step(self.state, dev_batch,
                                              self._lrs())
        self.loss.accumulate(
            {k.split("/", 1)[1]: v for k, v in metrics.items()
             if k.startswith("loss/") and k != "loss/total"}, rows)
        self.scheduler.warmup_step()
        return metrics

    def _end_train_epoch(self) -> tp.Dict[str, tp.Any]:
        if not self.scheduler.requires_metric:
            self.scheduler.step()  # else valid_epoch steps with the metric
        return {"scalars": self.loss.reduce()}

    def train_epoch(self, dataloader: tp.Iterable[tp.Mapping[str, tp.Any]]
                    ) -> tp.Dict[str, tp.Any]:
        """One pass over {"clean", "noisy"} batches."""
        self.loss.initialize()
        for idx, batch in enumerate(dataloader, start=1):
            self._step_and_account(*self._device_batch(batch,
                                                       ("clean", "noisy")))
            if self.test and idx >= 10:
                break
        return self._end_train_epoch()

    def valid_epoch(self, dataloader: tp.Iterable[tp.Mapping[str, tp.Any]]
                    ) -> tp.Dict[str, tp.Any]:
        """Valid losses over {"clean", "noisy"} batches, eval-mode BN; a
        metric-driven scheduler (ReduceLROnPlateau) steps on their total."""
        self.loss.initialize()
        for idx, batch in enumerate(dataloader, start=1):
            dev_batch, rows = self._device_batch(batch, ("clean", "noisy"))
            out = self.valid_step(self.state["variables"], dev_batch)
            self.loss.accumulate({k.split("/", 1)[1]: v
                                  for k, v in out.items()
                                  if k != "loss/total"}, rows)
            if self.test and idx >= 10:
                break
        summary = {"scalars": self.loss.reduce()}
        if self.scheduler is not None and self.scheduler.requires_metric:
            self.scheduler.step(sum(
                self.loss.weights[k.split("/", 1)[1]] * v
                for k, v in summary["scalars"].items()))
        return summary
