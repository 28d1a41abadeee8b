"""DynamicMixer: the device-side mixing of the shard training recipe.

Counterpart of fastenhancer_tpu/data/shard_mixer.py, pure math on tensors
(the probability decisions live in the host-side shard loader):

  1. batched FFT convolution with the RIRs;
  2. the dereverberated target: early_rir / weighted_rir / rts
     (arXiv 2204.08765) / anechoic;
  3. dBFS normalization by the segmental RMS of the reverberant input;
  4. SER echo mixing (rows of zeros add nothing);
  5. SNR noise mixing (rows of zeros add nothing);
  6. a joint peak clip of input and target.

The three segmental-RMS calls go through `ops.segmental_rms_fused`, one
kernel launch each on the card. `DynamicMixer.__call__` draws dBFS, SNR
and SER from a torch.Generator on the CPU (so a seed gives the same mix on
every device) and hands them to `DynamicMixer.mix`, a function of the
draws, which a test can also feed with the JAX package's draws.

`ShardBatch` is the host-side batch that data/shard.py assembles (a copy
of the JAX package's dataclass).
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from ..ops.segmental_rms import segmental_rms_fused

Tensor = torch.Tensor


@dataclasses.dataclass
class ShardBatch:
    """Host-side assembled batch (numpy)."""
    speech: np.ndarray                       # [B, 1, T] codec or clean
    speech_clean: tp.Optional[np.ndarray]    # [B, 1, T] always clean
    noise: tp.Optional[np.ndarray]           # [B, 1, T]
    rir: tp.Optional[np.ndarray]             # [B, 1, T_rir]
    rir_onset: tp.Optional[np.ndarray]       # [B]
    rir_t60: tp.Optional[np.ndarray]         # [B]
    num_samples: np.ndarray                  # [B]
    id_speech: tp.List[str]
    farend: tp.Optional[np.ndarray] = None   # [B, 1, T] far-end reference
    echo: tp.Optional[np.ndarray] = None     # [B, 1, T] aligned echo render
    is_real: tp.Optional[np.ndarray] = None  # [B] bool: recorded echo pair
    text: tp.Optional[tp.List[str]] = None   # transcript variant (WER eval)


def batch_convolve_rir(speech: Tensor, rirs: Tensor) -> Tensor:
    """Causal linear convolution per item; speech [B, 1, T], rirs
    [B, 1, T_rir], by FFT at the next power of two."""
    t = speech.shape[-1]
    t_rir = rirs.shape[-1]
    if t_rir == 1:
        return speech * rirs
    n = 1 << (t + t_rir - 2).bit_length()
    y = torch.fft.rfft(speech, n=n) * torch.fft.rfft(rirs, n=n)
    return torch.fft.irfft(y, n=n)[..., :t].to(speech.dtype)


def get_early_rir(rirs: Tensor, onset: Tensor, early_rir_sec: float = 0.05,
                  fs: int = 16_000) -> Tensor:
    b, _, t = rirs.shape
    stop = (onset + int(early_rir_sec * fs)).reshape(b, 1, 1)
    idx = torch.arange(t, device=rirs.device).reshape(1, 1, t)
    return rirs * (idx < stop)


def get_weighted_rir(rirs: Tensor, onset: Tensor, t60_max: float = 0.3,
                     fs: int = 16_000) -> Tensor:
    b, _, t = rirs.shape
    tt = torch.arange(t, dtype=torch.float32,
                      device=rirs.device).reshape(1, 1, t) / fs
    t0 = onset.float().reshape(b, 1, 1) / fs
    decay = torch.exp(-(tt - t0) * 6.0 * math.log(10.0) / t60_max)
    return rirs * torch.where(tt > t0, decay, 1.0)


def get_rts_rir(rirs: Tensor, onset: Tensor, t60: Tensor,
                t60_max: float = 0.15, fs: int = 16_000) -> Tensor:
    """Reverberation Time Shortening (arXiv 2204.08765)."""
    b, _, t = rirs.shape
    onset = onset.float().reshape(b, 1, 1)
    t60 = t60.float().reshape(b, 1, 1)
    n = torch.arange(t, dtype=torch.float32,
                     device=rirs.device).reshape(1, 1, t)
    # rows with t60 <= t60_max take the passthrough branch; clamp them away
    # from 0 so q stays finite (inf * 0 at n == onset would NaN the masked
    # branch)
    safe_t60 = t60.clamp_min(1e-4)
    q = 3.0 / fs * (1.0 / t60_max - 1.0 / safe_t60)
    # clamp the exponent: an unclamped 10^(+huge) on a passthrough row would
    # poison the where with inf * 0 NaNs in the backward
    decay = 10.0 ** (-q * (n - onset)).clamp_max(0.0)
    weighted = rirs * torch.where(n > onset, decay, 1.0)
    return torch.where(t60 <= t60_max, rirs, weighted)


class DynamicMixer:
    def __init__(
        self,
        speech_dbFS: tp.Sequence[float] = (-30.0, -15.0),
        ser_real: tp.Sequence[float] = (-10.0, 20.0),
        ser: tp.Sequence[float] = (-10.0, 20.0),
        snr: tp.Sequence[float] = (0.0, 30.0),
        sampling_rate: int = 16_000,
        seg_window_ms: int = 100,
        seg_rel_threshold: float = -25.0,
        seg_abs_threshold: tp.Optional[float] = -50.0,
        rir_target_type: tp.Optional[str] = None,
        early_rir_sec: float = 0.05,
        t60_max: float = 0.3,
    ):
        if rir_target_type not in (None, "early_rir", "weighted_rir",
                                   "anechoic", "rts"):
            raise ValueError(f"unknown rir_target_type {rir_target_type!r}")
        self.dbFS = tuple(speech_dbFS)
        self.ser_real = tuple(ser_real)
        self.ser = tuple(ser)
        self.snr = tuple(snr)
        self.sr = sampling_rate
        self.seg_window_ms = seg_window_ms
        self.seg_rel_thr = seg_rel_threshold
        self.seg_abs_thr = seg_abs_threshold
        self.rir_target_type = rir_target_type
        self.early_rir_sec = early_rir_sec
        self.t60_max = t60_max

    def _rms(self, wav: Tensor, absolute_threshold_db: tp.Optional[float]
             ) -> Tensor:
        return segmental_rms_fused(
            wav[:, 0], sr=self.sr, window_ms=self.seg_window_ms,
            relative_threshold_db=self.seg_rel_thr,
            absolute_threshold_db=absolute_threshold_db)

    def __call__(self, generator: torch.Generator, speech: Tensor,
                 speech_clean: tp.Optional[Tensor] = None,
                 noise: tp.Optional[Tensor] = None,
                 rir: tp.Optional[Tensor] = None,
                 rir_onset: tp.Optional[Tensor] = None,
                 rir_t60: tp.Optional[Tensor] = None,
                 echo: tp.Optional[Tensor] = None,
                 is_real: tp.Optional[Tensor] = None, *,
                 share: tp.Tuple[int, int] = (0, 1)
                 ) -> tp.Dict[str, tp.Optional[Tensor]]:
        """Every signal [B, 1, T] ([B] for onset, t60, is_real). Draws
        dBFS, SNR and SER uniformly in their ranges from `generator` (a
        CPU generator), then mixes. share=(rank, world): the draws are made
        for the world's global batch of world * B rows, one generator state
        on every rank, and this rank takes rows [rank * B, (rank + 1) * B).
        Returns {"speech" (the noisy input), "speech_clean" (the target),
        "dbFS", "snr", "ser"}."""
        b = speech.shape[0]
        rank, world = share

        def draw(lo_hi: tp.Sequence[float]) -> Tensor:
            u = torch.rand(b * world, generator=generator,
                           dtype=torch.float32)[rank * b:(rank + 1) * b]
            return (lo_hi[0] + u * (lo_hi[1] - lo_hi[0])).to(speech.device)

        dbfs, snr = draw(self.dbFS), draw(self.snr)
        ser_real, ser_sim = draw(self.ser_real), draw(self.ser)
        return self.mix(dbfs, snr, ser_real, ser_sim, speech, speech_clean,
                        noise, rir, rir_onset, rir_t60, echo, is_real)

    def mix(self, dbfs: Tensor, snr: Tensor, ser_real: Tensor,
            ser_sim: Tensor, speech: Tensor,
            speech_clean: tp.Optional[Tensor] = None,
            noise: tp.Optional[Tensor] = None,
            rir: tp.Optional[Tensor] = None,
            rir_onset: tp.Optional[Tensor] = None,
            rir_t60: tp.Optional[Tensor] = None,
            echo: tp.Optional[Tensor] = None,
            is_real: tp.Optional[Tensor] = None
            ) -> tp.Dict[str, tp.Optional[Tensor]]:
        """The mix for given draws: dbfs, snr, ser_real and ser_sim [B]
        (ser_real applies to rows with is_real, ser_sim to the others)."""
        b = speech.shape[0]
        # 1. RIR convolution
        inp = speech if rir is None else batch_convolve_rir(speech, rir)

        # 2. dereverberated target
        clean_out = None
        if speech_clean is not None:
            if self.rir_target_type == "anechoic" or rir is None:
                rir_target = None
            elif self.rir_target_type is None:
                rir_target = rir
            elif self.rir_target_type == "early_rir":
                rir_target = get_early_rir(rir, rir_onset, self.early_rir_sec,
                                           self.sr)
            elif self.rir_target_type == "rts":
                rir_target = get_rts_rir(rir, rir_onset, rir_t60,
                                         self.t60_max, self.sr)
            else:
                rir_target = get_weighted_rir(rir, rir_onset, self.t60_max,
                                              self.sr)
            clean_out = (speech_clean if rir_target is None
                         else batch_convolve_rir(speech_clean, rir_target))

        # 3. dBFS normalization from the reverberant input
        rms = self._rms(inp, None)
        target_rms = (10.0 ** (dbfs / 20.0)).reshape(b, 1, 1)
        scale = target_rms / rms.clamp_min(1e-10)
        inp = inp * scale
        if clean_out is not None:
            clean_out = clean_out * scale

        # 4. SER echo mixing (an all-zero echo row has rms +inf: scale 0)
        ser = None
        if echo is not None:
            rms_echo = self._rms(echo, self.seg_abs_thr)
            real = (is_real.bool() if is_real is not None
                    else torch.zeros(b, dtype=torch.bool, device=inp.device))
            ser = torch.where(real, ser_real, ser_sim)
            echo_scale = target_rms / (
                rms_echo * 10.0 ** (ser.reshape(b, 1, 1) / 20.0)
            ).clamp_min(1e-10)
            echo_scale = torch.where(torch.isfinite(echo_scale), echo_scale,
                                     0.0)
            inp = inp + echo_scale * echo

        # 5. SNR noise mixing (an all-zero noise row has rms +inf: scale 0)
        if noise is not None:
            rms_noise = self._rms(noise, self.seg_abs_thr)
            noise_scale = target_rms / (
                rms_noise * 10.0 ** (snr.reshape(b, 1, 1) / 20.0)
            ).clamp_min(1e-10)
            noise_scale = torch.where(torch.isfinite(noise_scale),
                                      noise_scale, 0.0)
            inp = inp + noise_scale * noise
        else:
            snr = None

        # 6. joint peak clip
        max_abs = inp.abs().amax(dim=(-2, -1), keepdim=True)
        if clean_out is not None:
            max_abs = torch.maximum(
                max_abs, clean_out.abs().amax(dim=(-2, -1), keepdim=True))
        denom = torch.where(max_abs > 1.0, max_abs + 1e-5, 1.0)
        inp = inp / denom
        if clean_out is not None:
            clean_out = clean_out / denom
        return {"speech": inp, "speech_clean": clean_out, "dbFS": dbfs,
                "snr": snr, "ser": ser}
