"""Shard-recipe training wrapper: fixed steps per epoch, the mixer on the
device.

Counterpart of fastenhancer_tpu/wrappers/ns_shard.py. Train batches are
`ShardBatch`es (speech, speech_clean, noise, RIRs) from any iterator;
`_mix_to_device` moves one to the device and runs the `DynamicMixer`
there, two or three segmental-RMS kernel launches, ahead of the train
step. `steps_per_epoch` bounds an epoch; the iterator starts again when
it runs out, and the
epoch's load / step wall split lands in `timing`; the progress line, the
profiler's window and the histograms are the base wrapper's. The valid,
PESQ and showcase sets are paired {"clean", "noisy"} batches
(`val_keys`, `infer_keys`), as in the base wrapper. Under several ranks
each rank reads its own shard draws (the reader seeds by rank), pads its
batch to the ranks' agreed shapes (`_reconcile_multihost`: a length bucket
differs from rank to rank, so every step agrees anew) and mixes its rows
with its share of the global batch's draws.
"""
from __future__ import annotations

import time
import typing as tp

import numpy as np
import torch

from .. import parallel
from ..data.shard_mixer import DynamicMixer, ShardBatch
from .ns import ModelWrapper as BaseModelWrapper

Tensor = torch.Tensor


class ModelWrapper(BaseModelWrapper):
    def __init__(self, hps: tp.Any, train: bool = False,
                 device: tp.Union[str, torch.device, None] = None):
        super().__init__(hps, train, device)
        hps = self.hps.to_dict()
        data = hps["data"]
        mixer_kwargs = dict(data.get("train", {}).get("mixer") or {})
        mixer_kwargs.update(data.get("dereverberation") or {})
        self.mixer = DynamicMixer(sampling_rate=self.sr, **mixer_kwargs)
        self.steps_per_epoch: int = hps.get("train", {}).get(
            "steps_per_epoch", 1000)
        # the mixer's dBFS/SNR/SER draws (on the CPU: the same on every
        # device for one seed)
        self.mix_generator = torch.Generator().manual_seed(self.seed)

    def set_keys(self) -> None:
        self.keys = ["speech", "speech_clean", "noise"]
        self.val_keys = ["clean", "noisy"]
        self.infer_keys = ["clean", "noisy", "wav_len"]

    def _mix_to_device(self, batch: ShardBatch
                       ) -> tp.Tuple[tp.Dict[str, Tensor], int]:
        """ShardBatch -> the mixed {"clean", "noisy", "row_mask"} on the
        device, cut to a multiple of the hop; returns (batch, this rank's
        real rows)."""
        arrs = {"speech": batch.speech, "speech_clean": batch.speech_clean,
                "noise": batch.noise, "echo": batch.echo}
        if batch.rir is not None:
            arrs.update(rir=batch.rir, rir_onset=batch.rir_onset,
                        rir_t60=batch.rir_t60)
        if batch.echo is not None:
            arrs["is_real"] = batch.is_real
        arrs = {k: np.asarray(a) for k, a in arrs.items() if a is not None}
        rows = arrs["speech"].shape[0]
        arrs["row_mask"] = np.ones(rows, np.float32)
        shared = tuple(k for k in ("speech", "speech_clean", "noise", "echo")
                       if k in arrs)
        if self.n_devices > 1:
            arrs = self._reconcile_multihost(arrs, shared_time_keys=shared)
        else:
            t = (arrs["speech"].shape[-1] // self.hop_size) * self.hop_size
            arrs.update({k: arrs[k][..., :t] for k in shared})
        dtypes = {"rir_onset": torch.int64, "is_real": torch.bool}
        dev = {k: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, dtypes.get(k, torch.float32))
            for k, a in arrs.items()}
        mixed = self.mixer(
            self.mix_generator, dev["speech"], dev.get("speech_clean"),
            dev.get("noise"), dev.get("rir"), dev.get("rir_onset"),
            dev.get("rir_t60"), echo=dev.get("echo"),
            is_real=dev.get("is_real"),
            share=(parallel.rank(), self.n_devices))
        return {"clean": mixed["speech_clean"][:, 0],
                "noisy": mixed["speech"][:, 0],
                "row_mask": dev["row_mask"]}, rows

    def train_epoch(self, dataloader: tp.Iterable[ShardBatch]
                    ) -> tp.Dict[str, tp.Any]:
        """steps_per_epoch train steps, each on a freshly mixed batch. The
        load time is the wall spent waiting for batches; the step time is
        the host's mix and step dispatch, and the closing reduction of the
        losses waits for the card."""
        self.loss.initialize()
        it = iter(dataloader)
        idx = 0
        fresh = True  # no batch yet from this iterator
        t_load = t_step = 0.0
        last_grads = None
        t_start = time.perf_counter()
        while idx < self.steps_per_epoch:
            t_mark = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                if fresh:
                    raise ValueError("the train batches ran out before the "
                                     "first step of a pass") from None
                it, fresh = iter(dataloader), True  # infinite epochs
                continue
            t_load += time.perf_counter() - t_mark
            fresh = False
            idx += 1
            t_mark = time.perf_counter()
            metrics = self._step_and_account(*self._mix_to_device(batch))
            last_grads = metrics.get("grads")
            t_step += time.perf_counter() - t_mark
            self._after_step(idx, self.steps_per_epoch, t_start,
                             f"  [load {t_load:.1f}s step {t_step:.1f}s]")
            if self.test and idx >= 50:
                break
        t_mark = time.perf_counter()
        summary = self._end_train_epoch(last_grads)
        t_step += time.perf_counter() - t_mark
        self.timing.update(load=t_load, step=t_step, steps=idx)
        return summary
