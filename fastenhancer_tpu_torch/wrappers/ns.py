"""Noise-suppression training wrapper on one device.

Counterpart of the single-device part of fastenhancer_tpu/wrappers/ns.py.
`ModelWrapper(hps, train=...)` builds, from a config HParams (from
`utils.hparams.get_hparams`, or over a preset as in
`HParams(**presets.FE_T_SHARD)`), the model of any family and its
variables, and with train=True the losses (the `pesq` loss at the data's
sampling rate), the optimizer, the scheduler, the train and valid steps
(train.remat sets the model's gradient checkpointing) and, where the
config has a `pesq` section, the PESQ loader and the `Metrics` executor.
`train_epoch` and `valid_epoch` run over any iterable of {"clean",
"noisy"} numpy batches; `valid_epoch(calculate_metrics=True)` also
enhances the PESQ set (float32, `make_infer_fn`) and scores it;
`infer_epoch` enhances the showcase files into audio, spectrogram and
SISDR summaries. Each returns the summary dicts `utils.summarize`
writes. `train.plot_param_and_grad` adds the last step's parameters and
gradients to the train summary as histograms, and `train.profile` traces
a window of train steps (`utils/profiler.py`). `save(epoch)` /
`load(epoch=None)` write and read the JAX package's checkpoint files
(`train/checkpoint.py`).

Not ported yet: several devices and hosts (ROADMAP queue 1, "Several
cards").
"""
from __future__ import annotations

import copy
import os
import time
import typing as tp

import numpy as np
import torch

from .. import require_cuda
from ..data import get_dataset_dataloader
from ..functional import STFTConfig, spec_to_mel, stft
from ..losses import Losses
from ..metrics import Metrics, sisdr
from ..models import get_model
from ..optim import get_optimizer, get_scheduler
from ..train import (latest_checkpoint, load_checkpoint, make_infer_fn,
                     make_train_step, make_valid_step, save_checkpoint)
from ..utils.hparams import HParams
from ..utils.profiler import make_profiler
from ..utils.summarize import plot_param_and_grad
from ..utils.terminal import clear_current_line, verbose
from ..utils.tree import tree_paths

Tensor = torch.Tensor


class ModelWrapper:
    def __init__(self, hps: HParams, train: bool = False,
                 device: tp.Union[str, torch.device, None] = None):
        """device: the card (`require_cuda()`) unless the caller names
        another, as the CPU tests do with device="cpu"."""
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.hps = hps
        self.base_dir: str = hps.get("base_dir") or ""
        hps = hps.to_dict()
        self.model = get_model(hps["model"], **hps["model_kwargs"])
        self.train_mode = train
        self.epoch = 0
        self.sr: int = hps["data"]["sampling_rate"]
        self.hop_size: int = self.model.hop_size
        self.keys: tp.List[str] = []
        self.infer_keys: tp.List[str] = []
        self.set_keys()
        hp = hps.get("train", {})
        self.seed = hp.get("seed", 0)
        variables = self.model.init(
            torch.Generator().manual_seed(self.seed), self.device)
        self.infer_fn = make_infer_fn(self.model)
        self.state: tp.Dict[str, tp.Any] = {"variables": variables}
        self.metrics: tp.Optional[Metrics] = None
        self.pesq_loader = None
        self.scheduler = None
        self.test = False
        # the last epoch's wall seconds: "load" and "step" (waiting for
        # train batches, mixing and stepping; ns_shard, with "steps"),
        # "valid" (valid losses), "metrics" (PESQ/STOI)
        self.timing: tp.Dict[str, float] = {}
        self.print_interval: int = hp.get("print_interval", 1)
        self.plot_param_and_grad = False
        self.profiler = None
        if not train:
            return
        self.test = hp.get("test", False)
        if self.test:
            self.hps.train.max_epochs = 1
        # fp16: True in the reference configs means bfloat16 compute over
        # float32 masters here, as in the JAX package (no gradient scaler)
        use_mixed = hp.get("fp16", False) or hp.get("bf16", False)
        self.compute_dtype = torch.bfloat16 if use_mixed else None
        self.model.remat = bool(hp.get("remat", False))
        self.plot_param_and_grad = bool(hp.get("plot_param_and_grad", False))
        self.profiler = make_profiler(hp, self.base_dir, self.device)
        losses_cfg = copy.deepcopy(dict(hp["losses"]))
        if "consistency" in losses_cfg:
            mk = hps["model_kwargs"]
            losses_cfg["consistency"].update(
                n_fft=mk["n_fft"], hop_size=mk["hop_size"],
                win_size=mk.get("win_size"), win_type=mk.get("window"))
        if "pesq" in losses_cfg:
            losses_cfg["pesq"].setdefault("sample_rate", self.sr)
        self.loss = Losses(losses_cfg)
        self.optim = get_optimizer(self.model, variables["params"], hp)
        self.scheduler = get_scheduler(self.optim, hp)
        self.train_step = make_train_step(
            self.model, self.loss, self.optim,
            clip_grad=hp.get("clip_grad"),
            clip_grad_kwargs=hp.get("clip_grad_kwargs"),
            compute_dtype=self.compute_dtype,
            skip_nonfinite=hp.get("skip_nonfinite_grads", False),
            return_grads=self.plot_param_and_grad)
        self.valid_step = make_valid_step(self.model, self.loss,
                                          self.compute_dtype)
        if "pesq" in hps:
            pesq = hps["pesq"]
            self.pesq_interval: int = pesq["interval"]
            _, self.pesq_loader = get_dataset_dataloader(
                self.hps, "pesq", ["clean", "noisy", "wav_len"])
            self.metrics = Metrics(
                num_workers=pesq.get("num_workers_executor", 8), sr=self.sr,
                **pesq["metrics_to_calculate"])
        else:
            self.pesq_interval = hp["max_epochs"] + 1

    def set_keys(self) -> None:
        self.keys = ["clean", "noisy"]
        self.infer_keys = self.keys + ["wav_len"]

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

    def _after_step(self, idx: int, total: tp.Optional[int], t0: float,
                    extra: str = "") -> None:
        """The progress line every `print_interval` steps (no wait for the
        card), then the profiler's step."""
        if verbose() and idx % self.print_interval == 0:
            dt = time.perf_counter() - t0
            line = f"\rEpoch {self.epoch} - Train {idx}"
            if total:
                line += (f"/{total} ({idx / total * 100:>4.1f}%){extra}"
                         f"  [{int(dt)}/{int(dt / idx * total)} sec]")
            print(line, end="", flush=True)
        if self.profiler is not None:
            self.profiler.step()

    def _end_train_epoch(self, last_grads: tp.Any = None
                         ) -> tp.Dict[str, tp.Any]:
        """Close the profiler's window, clear the progress line, step the
        schedule; the losses' means, and with plot_param_and_grad the last
        step's params and gradients as histograms."""
        if self.profiler is not None:
            self.profiler.close()
        if verbose():
            clear_current_line()
        if not self.scheduler.requires_metric:
            self.scheduler.step()  # else valid_epoch steps with the metric
        summary: tp.Dict[str, tp.Any] = {"scalars": self.loss.reduce(),
                                         "hists": {}}
        if self.plot_param_and_grad:
            plot_param_and_grad(summary["hists"],
                                self.state["variables"]["params"],
                                grads=last_grads)
        return summary

    def train_epoch(self, dataloader: tp.Iterable[tp.Mapping[str, tp.Any]]
                    ) -> tp.Dict[str, tp.Any]:
        """One pass over {"clean", "noisy"} batches; self.timing gets the
        epoch's wall seconds waiting for batches ("load") and moving and
        stepping them ("step", host clock, the queue drained at the end),
        and the step count ("steps")."""
        self.loss.initialize()
        total = len(dataloader) if hasattr(dataloader, "__len__") else None
        load = step = 0.0
        steps = 0
        last_grads = None
        t_start = time.perf_counter()
        batches = iter(dataloader)
        while not (self.test and steps >= 10):
            t0 = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            load += t1 - t0
            if batch is None:
                break
            metrics = self._step_and_account(
                *self._device_batch(batch, ("clean", "noisy")))
            last_grads = metrics.get("grads")
            steps += 1
            step += time.perf_counter() - t1
            self._after_step(steps, total, t_start)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timing.update(load=load, steps=steps,
                           step=step + time.perf_counter() - t0)
        return self._end_train_epoch(last_grads)

    def valid_epoch(self, dataloader: tp.Iterable[tp.Mapping[str, tp.Any]],
                    calculate_metrics: bool = False
                    ) -> tp.Dict[str, tp.Any]:
        """Valid losses over {"clean", "noisy"} batches, eval-mode BN; a
        metric-driven scheduler (ReduceLROnPlateau) steps on their total.
        With calculate_metrics (and a `pesq` section), the PESQ set is
        enhanced and scored too: "metrics/pesq", "metrics/stoi"."""
        t0 = time.perf_counter()
        self.loss.initialize()
        if calculate_metrics and self.metrics is not None:
            self.metrics.initialize()
        for idx, batch in enumerate(dataloader, start=1):
            dev_batch, rows = self._device_batch(batch, ("clean", "noisy"))
            out = self.valid_step(self.state["variables"], dev_batch)
            self.loss.accumulate({k.split("/", 1)[1]: v
                                  for k, v in out.items()
                                  if k != "loss/total"}, rows)
            if self.test and idx >= 10:
                break
        summary = {"scalars": self.loss.reduce()}
        self.timing["valid"] = time.perf_counter() - t0
        if (self.train_mode and self.scheduler is not None
                and self.scheduler.requires_metric):
            self.scheduler.step(sum(
                self.loss.weights[k.split("/", 1)[1]] * v
                for k, v in summary["scalars"].items()))
        if calculate_metrics and self.metrics is not None and self.pesq_loader:
            t0 = time.perf_counter()
            self.calculate_metrics(self.pesq_loader)
            summary["scalars"].update(self.metrics.retrieve(self.epoch))
            self.timing["metrics"] = time.perf_counter() - t0
        return summary

    def calculate_metrics(self, dataloader: tp.Iterable[
            tp.Mapping[str, tp.Any]]) -> None:
        """Enhance {"clean", "noisy", "wav_len"} batches with the float32
        offline forward and submit them to the PESQ/STOI executor."""
        for idx, batch in enumerate(dataloader, start=1):
            dev_batch, rows = self._device_batch(batch, ("clean", "noisy"))
            wav_hat = self.infer_fn(self.state["variables"],
                                    dev_batch["noisy"]).cpu().numpy()
            clean = dev_batch["clean"].cpu().numpy()
            wav_len = batch.get("wav_len")
            if wav_len is not None:
                wav_len = np.minimum(np.asarray(wav_len), wav_hat.shape[-1])
            self.metrics.submit(clean[:rows], wav_hat[:rows], wav_len)
            if self.test and idx >= 2:
                break

    def infer_epoch(self, dataloader: tp.Iterable[tp.Mapping[str, tp.Any]]
                    ) -> tp.Dict[str, tp.Any]:
        """Enhance the showcase files (the first row of each batch, float32
        offline forward) -> audio, spectrogram and "infer/sisdr" summaries,
        under the batch's "filename" or else its index ("enhanced/00").
        The loader pads each file to a bucket length; the padding is cut
        off again by "wav_len". The noisy and clean audio are written only
        while epoch <= infer.interval; the spectrograms are the log10
        magnitude of STFT(1024, 256, 1024) of the enhanced audio and its
        80-band log-mel at the data's rate."""
        summary: tp.Dict[str, tp.Any] = {"audios": {}, "specs": {},
                                         "scalars": {}}
        cfg = STFTConfig(n_fft=1024, hop_size=256, win_size=1024)
        interval = self.hps.get("infer", {}).get("interval", 20)
        sisdrs = []
        for i, batch in enumerate(dataloader):
            noisy = np.asarray(batch["noisy"])
            clean = np.asarray(batch["clean"])
            t = (noisy.shape[-1] // self.hop_size) * self.hop_size
            wav_hat = self.infer_fn(
                self.state["variables"],
                torch.from_numpy(np.ascontiguousarray(
                    noisy[..., :t], np.float32)).to(self.device))
            spec_in = wav_hat[:1]
            wav_hat = wav_hat.cpu().numpy()
            wl = batch.get("wav_len")
            if wl is not None:
                n = min(int(wl[0]), t)
                noisy, clean, wav_hat = (noisy[..., :n], clean[..., :n],
                                         wav_hat[..., :n])
                spec_in = spec_in[..., :n]
                t = (n // self.hop_size) * self.hop_size
            name = batch.get("filename", [f"{i:02d}"])[0]
            if self.epoch <= interval:
                summary["audios"][f"noisy/{name}"] = noisy[0]
                summary["audios"][f"clean/{name}"] = clean[0]
            summary["audios"][f"enhanced/{name}"] = wav_hat[0]
            spec = stft(spec_in, cfg)
            mag = spec.square().sum(-1).sqrt()[0].cpu().numpy()
            summary["specs"][f"enhanced/{name}"] = np.log10(mag + 1e-5)
            summary["specs"][f"enhanced_mel/{name}"] = spec_to_mel(
                mag, sr=self.sr)
            sisdrs.append(sisdr(wav_hat[0, :t], clean[0, :t]))
        summary["scalars"]["infer/sisdr"] = float(np.mean(sisdrs))
        return summary

    # -- checkpoints -------------------------------------------------------------

    def save(self, epoch: int) -> str:
        """{base_dir}/{epoch:05d}.ckpt: the variables, the optimizer state
        in the JAX layout, the scheduler's and the metrics' state."""
        state = {"variables": self.state["variables"]}
        if self.train_mode:
            state["opt_state"] = self.optim.state_tree(
                self.state["variables"]["params"])
        return save_checkpoint(
            self.base_dir, epoch, state,
            scheduler_state=(self.scheduler.state_dict() if self.scheduler
                             else None),
            metrics=self.metrics.state_dict() if self.metrics else None)

    def load(self, epoch: tp.Optional[int] = None) -> bool:
        """Resume from {base_dir}/{epoch:05d}.ckpt or the latest one (False
        when there is none). The values are written into the live leaves,
        which the optimizer holds, so training goes on from them."""
        if epoch is not None:
            path = os.path.join(self.base_dir, f"{epoch:05d}.ckpt")
            if not os.path.exists(path):
                raise FileNotFoundError(path)
        else:
            path = latest_checkpoint(self.base_dir)
            if path is None:
                return False
        ckpt = load_checkpoint(path)
        variables = self.state["variables"]
        for part in ("params", "stats"):
            _copy_into(variables[part], ckpt["variables"][part],
                       f"checkpoint {part}")
        if self.train_mode and ckpt.get("opt_state") is not None:
            self.optim.load_state_tree(ckpt["opt_state"])
        if self.scheduler is not None and ckpt.get("scheduler") is not None:
            self.scheduler.load_state_dict(ckpt["scheduler"])
        if self.metrics is not None:
            self.metrics.load_state_dict(ckpt.get("metrics"))
        self.epoch = ckpt["epoch"]
        print(f"loaded checkpoint {path} (epoch {self.epoch})")
        return True


@torch.no_grad()
def _copy_into(live: tp.Any, saved: tp.Any, what: str) -> None:
    """Copy each array of `saved` into the tensor at the same path of
    `live`, in place; the paths and shapes must match."""
    have = dict(tree_paths(live))
    want = dict(tree_paths(saved))
    if have.keys() != want.keys():
        raise ValueError(f"{what}: paths differ: missing "
                         f"{sorted(have.keys() - want.keys())[:4]}, "
                         f"unknown {sorted(want.keys() - have.keys())[:4]}")
    for path, t in have.items():
        a = torch.from_numpy(np.array(want[path]))
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{what} at {'.'.join(path)}: shape "
                             f"{tuple(a.shape)} != {tuple(t.shape)}")
        t.copy_(a)
