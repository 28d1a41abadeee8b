"""Noise-suppression training wrapper, on one device or one rank of several.

Counterpart of fastenhancer_tpu/wrappers/ns.py.
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

Under W ranks (`parallel`, one process per card) each rank loads its own
stride of the batches; `_device_batch` pads each rank's batch to the
shapes the ranks agree on (`_reconcile_multihost`, with padded rows masked
out), and the steps take the global batch's BN statistics, losses and
gradients, so W ranks at batch B train as one process at W * B. The valid
losses and PESQ/STOI are averaged over the ranks
(`_merge_across_hosts`); each rank scores its own rows. The caller runs
`infer_epoch` and `save` on rank 0 only and `load` on every rank.
"""
from __future__ import annotations

import copy
import os
import time
import typing as tp
import zlib

import numpy as np
import torch

from .. import parallel, require_cuda
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
        self.n_devices = parallel.world()
        # the ranks' agreed batch shapes: fixed-segment training that drops
        # its ragged tail has one shape, agreed once and cached
        # (_reconcile_multihost)
        self._mh_dims_cache: tp.Dict[tuple, tuple] = {}
        self._mh_static_train = bool(
            hp and (hps["data"].get("train") or {}).get("segment_size")
            and hp.get("drop_last", False))
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
                      keys: tp.Sequence[str], static_shapes: bool = False
                      ) -> tp.Tuple[tp.Dict[str, Tensor], int]:
        """The batch's `keys` cut to a multiple of the hop and moved to the
        device as float32, with "row_mask" [B] (1 a real row, 0 a padded
        one); returns (batch, this rank's real rows). Under several ranks
        the arrays are padded to the ranks' agreed shapes first
        (_reconcile_multihost; static_shapes: see there)."""
        arrs = {k: np.asarray(batch[k]) for k in keys if k in batch}
        b = next(iter(arrs.values())).shape[0]
        arrs["row_mask"] = np.ones(b, np.float32)
        if self.n_devices > 1:
            # hop-floored after the ranks' max, so no rank drops samples
            # that another keeps
            shared = tuple(k for k, a in arrs.items()
                           if k != "row_mask" and a.ndim > 1)
            arrs = self._reconcile_multihost(arrs, shared,
                                             static_shapes=static_shapes)
        else:
            t = min(a.shape[-1] for a in arrs.values() if a.ndim > 1)
            t = (t // self.hop_size) * self.hop_size
            arrs = {k: (a[..., :t] if a.ndim > 1 else a)
                    for k, a in arrs.items()}
            arrs, _ = parallel.pad_batch_to(arrs, self.n_devices)
        return {k: torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(self.device)
            for k, a in arrs.items()}, b

    def _reconcile_multihost(self, arrs: tp.Dict[str, np.ndarray],
                             shared_time_keys: tp.Sequence[str],
                             static_shapes: bool = False
                             ) -> tp.Dict[str, np.ndarray]:
        """Pad this rank's arrays to the shapes every rank agrees on.

        Each rank loads its own stride of the batches, so a step's global
        batch is the rows of every rank. The ranks agree on its shapes in
        one small all-gather of their dims a step:
          * `shared_time_keys` (waveforms sharing the sample axis) are cut
            or zero-padded to the hop-floored maximum over the ranks of
            their shortest length, as one process's collate pads to the
            batch's longest item, so W ranks at B see the batch of one
            process at W * B;
          * other arrays of two or more dims (`rir`, at its natural
            length) are zero-padded, never cut, to their own maximum;
          * rows are zero-padded to the ranks' largest row count and
            masked out in "row_mask".
        A fingerprint of the key sets rides along: ranks that run
        different configs raise instead of pairing the wrong columns.

        `static_shapes=True` (fixed-segment training with drop_last)
        promises that this rank's dims repeat each step: the all-gather
        runs once and is cached. Every rank takes the same branch, so the
        collectives stay in step; a rank whose dims change raises before
        any collective instead of leaving the others waiting."""
        world = self.n_devices
        keys = sorted(arrs)
        shared = [k for k in keys if k in shared_time_keys]
        pad_only = [k for k in keys if k not in shared_time_keys
                    and np.ndim(arrs[k]) >= 2]
        b = int(np.shape(arrs[keys[0]])[0])
        t_shared = (min(int(np.shape(arrs[k])[-1]) for k in shared)
                    if shared else 0)
        fp = zlib.crc32(repr((keys, shared, pad_only)).encode()) & 0x7FFFFFFF
        sig = (fp, b, t_shared) + tuple(
            int(np.shape(arrs[k])[-1]) for k in pad_only)

        cached = self._mh_dims_cache.get(sig) if static_shapes else None
        if cached is None:
            if static_shapes and self._mh_dims_cache:
                raise RuntimeError(
                    "multihost static_shapes promised but the local batch "
                    f"dims changed (cached {sorted(self._mh_dims_cache)}, "
                    f"got {sig}); fixed-segment training must use "
                    "drop_last=True so every step has one batch shape")
            g = parallel.all_gather_ints(sig).reshape(world, len(sig))
            if not (g[:, 0] == g[0, 0]).all():
                raise RuntimeError(
                    "multihost batch key sets differ across processes "
                    f"(fingerprints {g[:, 0].tolist()}); every process must "
                    "run the identical config")
            rows = int(g[:, 1].max())  # one card a rank: no row multiple
            t_c = ((int(g[:, 2].max()) // self.hop_size) * self.hop_size
                   if shared else 0)
            pad_dims = {k: int(g[:, 3 + i].max())
                        for i, k in enumerate(pad_only)}
            cached = (rows, t_c, pad_dims)
            if static_shapes:
                self._mh_dims_cache[sig] = cached
        rows, t_c, pad_dims = cached

        out = {}
        for k, a in arrs.items():
            a = np.asarray(a)
            widths = [(0, 0)] * a.ndim
            if k in shared_time_keys:
                if a.shape[-1] > t_c:
                    a = a[..., :t_c]
                elif a.shape[-1] < t_c:
                    widths[-1] = (0, t_c - a.shape[-1])
            elif k in pad_dims and a.shape[-1] < pad_dims[k]:
                widths[-1] = (0, pad_dims[k] - a.shape[-1])
            if a.shape[0] < rows:
                widths[0] = (0, rows - a.shape[0])
            if any(wd != (0, 0) for wd in widths):
                a = np.pad(a, widths)
            out[k] = a
        return out

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
        """The progress line every `print_interval` steps, then the
        profiler's step. The JAX package's line also shows the running
        losses (`Losses.print`); reading them waits for the card, so this
        one leaves them out."""
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
            metrics = self._step_and_account(*self._device_batch(
                batch, ("clean", "noisy"),
                static_shapes=self._mh_static_train))
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
        summary = {"scalars": self._merge_across_hosts(self.loss.reduce())}
        self.timing["valid"] = time.perf_counter() - t0
        if (self.train_mode and self.scheduler is not None
                and self.scheduler.requires_metric):
            self.scheduler.step(sum(
                self.loss.weights[k.split("/", 1)[1]] * v
                for k, v in summary["scalars"].items()))
        if calculate_metrics and self.metrics is not None and self.pesq_loader:
            t0 = time.perf_counter()
            self.calculate_metrics(self.pesq_loader)
            summary["scalars"].update(self._merge_across_hosts(
                self.metrics.retrieve(self.epoch)))
            self.timing["metrics"] = time.perf_counter() - t0
        return summary

    def _merge_across_hosts(self, scalars: tp.Dict[str, float]
                            ) -> tp.Dict[str, float]:
        """Under several ranks, each scalar averaged over the ranks in
        float32 (each rank evaluated its own stride of the data); the
        ranks' key sets must agree. One rank: the scalars as they are."""
        if self.n_devices == 1:
            return scalars
        keys = sorted(scalars)
        fp = zlib.crc32(repr(keys).encode()) & 0x7FFFFFFF
        g = parallel.all_gather_ints([fp])
        if not (g == g[0]).all():
            raise RuntimeError(f"the ranks report different scalars "
                               f"(fingerprints {g[:, 0].tolist()}, here "
                               f"{keys})")
        if not keys:
            return scalars
        vals = parallel.all_gather_floats([scalars[k] for k in keys])
        return dict(zip(keys, vals.mean(axis=0).tolist()))

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
        if verbose():
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
