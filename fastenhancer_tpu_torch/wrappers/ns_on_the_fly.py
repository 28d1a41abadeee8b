"""On-the-fly wrapper: SNR mixing (and the optional dynamic low-pass) on the
device ahead of each train step.

Counterpart of fastenhancer_tpu/wrappers/ns_on_the_fly.py. The train
dataset yields (clean, noise[, rir]) items; `_device_batch` moves a batch
to the device and mixes it there. The per-batch SNR and dBFS draws and the per-item
low-pass kernels are drawn on the host each step, as in the JAX package.
Valid and PESQ batches are paired {"clean", "noisy"} wavs and go through
the base wrapper. Under several ranks each rank pads its (clean, noise[,
rir]) batch to the ranks' agreed shapes first (`_reconcile_multihost`;
`rir` padded, never cut), and takes its rows of the low-pass kernels drawn
for the global batch.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .. import parallel
from ..data.ns_on_the_fly import DynamicBatchLPF, SNRMixer
from .ns import ModelWrapper as BaseModelWrapper

Tensor = torch.Tensor


class ModelWrapper(BaseModelWrapper):
    def __init__(self, hps: tp.Any, train: bool = False,
                 device: tp.Union[str, torch.device, None] = None):
        super().__init__(hps, train, device)
        data = self.hps.data
        self.snr_mixer = SNRMixer(sr=self.sr, **data.snr_mixer.to_dict())
        lpf = data.dynamic_lpf.to_dict() if "dynamic_lpf" in data else {
            "p_lpf": 0.0}
        self.dynamic_lpf = DynamicBatchLPF(sampling_rate=self.sr, **lpf)
        self._lpf_rng = np.random.default_rng(
            getattr(self.hps.train, "seed", 0) if "train" in self.hps else 0)

    def set_keys(self) -> None:
        self.keys = ["clean", "noise", "noisy"]
        # reverb recipes: the dataset draws a per-item RIR (a unit impulse
        # with probability 1 - reverb_prob) and the mixer convolves clean
        # with it before mixing
        if self.hps.data.get("reverb_prob", 0) > 0:
            self.keys = self.keys + ["rir"]
        self.infer_keys = ["clean", "noise", "noisy", "wav_len"]

    def _device_batch(self, batch: tp.Mapping[str, np.ndarray],
                      keys: tp.Sequence[str], static_shapes: bool = False
                      ) -> tp.Tuple[tp.Dict[str, Tensor], int]:
        """(clean, noise[, rir]) -> the mixed {"clean", "noisy",
        "row_mask"} on the device, clean and noise cut to the shorter of
        the two in whole hops; returns (batch, this rank's real rows).
        Other batches (valid, PESQ: paired wavs) go to the base class."""
        if "noise" not in batch:
            return super()._device_batch(batch, keys, static_shapes)
        names = ("clean", "noise", "rir") if "rir" in batch else (
            "clean", "noise")
        arrs = {k: np.asarray(batch[k]) for k in names}
        rows = arrs["clean"].shape[0]
        arrs["row_mask"] = np.ones(rows, np.float32)
        if self.n_devices > 1:
            arrs = self._reconcile_multihost(
                arrs, shared_time_keys=("clean", "noise"),
                static_shapes=static_shapes)
        else:
            t = min(arrs[k].shape[-1] for k in ("clean", "noise"))
            t = (t // self.hop_size) * self.hop_size
            arrs.update(clean=arrs["clean"][..., :t],
                        noise=arrs["noise"][..., :t])
        dev = {k: torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(self.device) for k, a in arrs.items()}
        snr, rms_target = self.snr_mixer.sample_params()
        clean, _, noisy = self.snr_mixer(dev["clean"], dev["noise"], snr,
                                         rms_target, dev.get("rir"))
        if self.dynamic_lpf.p_lpf > 0:
            # drawn for the global batch; this rank takes its rows
            b, r = clean.shape[0], parallel.rank()
            kernels = self.dynamic_lpf.sample_kernels(
                b * self.n_devices, self._lpf_rng)[r * b:(r + 1) * b]
            clean = self.dynamic_lpf(clean, kernels)
            noisy = self.dynamic_lpf(noisy, kernels)
        return {"clean": clean, "noisy": noisy,
                "row_mask": dev["row_mask"]}, rows
