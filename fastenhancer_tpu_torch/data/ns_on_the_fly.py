"""On-the-fly noise-suppression pipeline: host synthesis, mixing on the
device.

Counterpart of fastenhancer_tpu/data/ns_on_the_fly.py (the port imports
nothing of the JAX package):

  * `NSOnTheFlyDataset` (host, numpy): fixed-length training clips made by
    concatenating randomly drawn clean and noise files with silence gaps,
    each normalised to a target dBFS by its active-segment RMS. It draws
    from Python's module-level `random` and `np.random` exactly as the JAX
    package does, so both give the same items from the same seeds.
  * `SNRMixer` (device, torch): per-batch SNR and output-dBFS mixing with a
    clipping-safe joint rescale and an optional batched RIR convolution.
    The SNR and dBFS draws are made on the host per batch
    (`sample_params`); the mixing runs on the batch's device.
  * `DynamicBatchLPF`: per-item random sinc low-pass (48 kHz bandwidth
    augmentation); the kernels are drawn on the host, one grouped conv on
    the device applies them.

The mixer's active RMS (a mean of segment RMS values above an absolute
threshold) is plain torch, as it is plain jnp in the JAX package; it is not
the shard mixer's segmental RMS (kernel #4).
"""
from __future__ import annotations

import random
import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .audio_io import read_wav

Scalar = tp.Union[int, float]
Tensor = torch.Tensor


def list_audio_files(
    directory: Path,
    ext_list: tp.Sequence[str] = (".wav", ".WAV", ".flac", ".FLAC"),
) -> tp.List[str]:
    out = []
    for p in sorted(directory.rglob("*")):
        if p.is_file() and any(p.name.endswith(e) for e in ext_list):
            out.append(str(p.relative_to(directory)))
    return out


class NSOnTheFlyDataset:
    """Synthesizes (clean, noise[, rir]) items of exactly segment_size
    samples."""

    def __init__(self, hp, keys: tp.List[str], textprocessor=None,
                 mode: str = "train", batch_size: int = 1,
                 verbose: bool = False):
        del textprocessor, batch_size, verbose
        self.keys = list(keys)
        self.sr: int = hp.sampling_rate
        self.silence = np.zeros(int(hp.silence_length * self.sr), np.float32)

        mx = hp.snr_mixer
        self.segmental_snr: bool = mx.segmental_snr
        self.rms_window_size = round(mx.rms_window_size * self.sr)
        self.activity_threshold = 10 ** (mx.activity_threshold / 20)
        self.target_rms = 10 ** (mx.dataloader_rms / 20)
        self.clean_activity_threshold = mx.clean_activity_threshold
        self.noise_activity_threshold = mx.noise_activity_threshold

        sec = hp[mode]
        self.segment_size: int = sec.segment_size
        self.clean_dir = Path(sec.clean_dir)
        self.noise_dir = Path(sec.noise_dir)
        self.length: int = sec["length"]

        self.clean_filelist = list_audio_files(self.clean_dir)
        self.noise_filelist = list_audio_files(self.noise_dir)

        self.reverb_prob: float = hp.reverb_prob
        assert 0 <= self.reverb_prob <= 1
        self.rir_length = 0
        self.rir_dir: tp.Optional[Path] = None
        self.rir_filelist: tp.List[str] = []
        self.empty_rir = np.array([], np.float32)
        if self.reverb_prob > 0:
            self.rir_length = hp.rir_length
            self.empty_rir = np.zeros(self.rir_length, np.float32)
            self.empty_rir[0] = 1.0
            self.rir_dir = Path(sec.rir_dir)
            self.rir_filelist = list_audio_files(self.rir_dir)

    def __len__(self) -> int:
        return self.length

    def shuffle(self, seed: int) -> None:
        random.Random(seed).shuffle(self.clean_filelist)
        random.Random(seed).shuffle(self.noise_filelist)

    def rms(self, wav: np.ndarray, activity_ratio: float) -> float:
        """Active-segment RMS; 0 when too few segments are active."""
        if not self.segmental_snr:
            return float(np.sqrt(np.square(wav).mean()))
        num_seg = len(wav) // self.rms_window_size
        wav = wav[: num_seg * self.rms_window_size].reshape(
            -1, self.rms_window_size)
        seg_rms = np.sqrt(np.square(wav).mean(1))
        active = seg_rms > self.activity_threshold
        n_active = active.sum()
        if n_active < activity_ratio * num_seg:
            return 0.0
        if n_active == 0:
            return float("inf")
        return float((seg_rms * active).sum() / n_active)

    def gen_audio(self, base_dir: Path, filelist: tp.List[str],
                  activity_ratio: float
                  ) -> tp.Tuple[np.ndarray, tp.List[str]]:
        """Random files, each followed by a silence gap, up to
        segment_size; the last one cropped at a random start. A file with
        too little activity (RMS 0) is skipped."""
        parts: tp.List[np.ndarray] = []
        names: tp.List[str] = []
        remaining = self.segment_size
        while remaining > 0:
            name = random.choice(filelist)
            audio, _ = read_wav(str(base_dir / name), sr=self.sr)
            names.append(name)
            rms = self.rms(audio, activity_ratio)
            if rms == 0.0:
                continue
            audio = audio * (self.target_rms / (rms + 1e-12))
            if remaining > len(audio):
                remaining -= len(audio)
                gap = min(remaining, len(self.silence))
                parts.extend([audio, self.silence[:gap]])
                remaining -= gap
            else:
                start = random.randint(0, len(audio) - remaining)
                parts.append(audio[start: start + remaining])
                remaining = 0
        return np.concatenate(parts).astype(np.float32), names

    def __getitem__(self, idx: int) -> tp.Dict[str, tp.Any]:
        del idx
        data: tp.Dict[str, tp.Any] = {}
        clean_names = noise_names = None
        if "clean" in self.keys:
            data["clean"], clean_names = self.gen_audio(
                self.clean_dir, self.clean_filelist,
                self.clean_activity_threshold)
        if "noise" in self.keys:
            data["noise"], noise_names = self.gen_audio(
                self.noise_dir, self.noise_filelist,
                self.noise_activity_threshold)
        if "rir" in self.keys:
            use_reverb = bool(np.random.random() < self.reverb_prob)
            if use_reverb:
                rir, _ = read_wav(
                    str(self.rir_dir / random.choice(self.rir_filelist)),
                    sr=self.sr)
                assert len(rir) <= self.rir_length, \
                    "rir longer than hp.rir_length"
                rir = np.pad(rir, (0, self.rir_length - len(rir)))
            else:
                rir = self.empty_rir
            data["rir"] = rir.astype(np.float32)
            if "is_reverb" in self.keys:
                data["is_reverb"] = use_reverb
        if "filename" in self.keys:
            data["filename"] = {"clean": clean_names, "noise": noise_names}
        return data


class SNRMixer:
    """Batch mixer on the device.

    __call__(clean, noise, snr, rms_target[, rir]) -> (clean, noise, noisy);
    snr (dB, an int draw) and rms_target (dBFS) are per-batch host draws
    from `sample_params`.
    """

    def __init__(
        self,
        sr: int,
        segmental_snr: bool = True,
        activity_threshold: Scalar = -50,
        rms_window_size: float = 0.1,
        dataloader_rms: int = -25,
        snr_range: tp.Sequence[int] = (-5, 20),
        noisy_rms_range: tp.Sequence[int] = (-35, -15),
        clean_activity_threshold: float = 0.5,
        noise_activity_threshold: float = 0.0,
        clipping_threshold: float = 1.0 - np.finfo(np.float32).eps,
    ):
        self.segmental_snr = segmental_snr
        # half-open ranges: list(range(*snr_range))
        self.snr_choices = list(range(*snr_range))
        self.rms_choices = list(range(*noisy_rms_range))
        self.sr = sr
        self.activity_threshold = 10 ** (activity_threshold / 20)
        self.window_size = int(sr * rms_window_size)
        self.clipping_threshold = float(clipping_threshold)
        self.rms_dataloader = 10 ** (dataloader_rms / 20)
        self.clean_activity_threshold = clean_activity_threshold
        self.noise_activity_threshold = noise_activity_threshold

    def sample_params(self, rng: tp.Optional[random.Random] = None
                      ) -> tp.Tuple[int, int]:
        r = rng or random
        return r.choice(self.snr_choices), r.choice(self.rms_choices)

    def active_rms(self, wav: Tensor) -> tp.Tuple[Tensor, Tensor]:
        """[B, T] -> (the mean RMS of the active segments [B, 1], whether
        enough segments are active [B, 1])."""
        b, t = wav.shape
        num_seg = t // self.window_size
        w = wav[:, : num_seg * self.window_size].reshape(b, num_seg,
                                                         self.window_size)
        rms = torch.sqrt(torch.mean(torch.square(w), dim=2))  # [B, S]
        active = rms > self.activity_threshold
        n_active = active.sum(dim=1).to(wav.dtype)
        active_rms = (active * rms).sum(dim=1) / torch.clamp(n_active,
                                                             min=1e-5)
        mask = n_active >= self.clean_activity_threshold * num_seg
        return active_rms[:, None], mask[:, None]

    def _rescale_no_clip(self, scale: Tensor, clean: Tensor, noise: Tensor,
                         noisy: Tensor
                         ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        max_abs = torch.maximum(
            clean.abs().amax(1, keepdim=True),
            torch.maximum(noise.abs().amax(1, keepdim=True),
                          noisy.abs().amax(1, keepdim=True)))
        scale = torch.minimum(scale, self.clipping_threshold / max_abs)
        return clean * scale, noise * scale, noisy * scale

    def _normalize_out(self, clean: Tensor, noise: Tensor, noisy: Tensor,
                       rms_target: Tensor
                       ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        rms_noisy = torch.sqrt(torch.mean(torch.square(noisy), 1,
                                          keepdim=True))
        rms_noisy = torch.clamp(rms_noisy, min=self.activity_threshold)
        scale = 10.0 ** (rms_target / 20.0) / rms_noisy
        return self._rescale_no_clip(scale, clean, noise, noisy)

    def __call__(self, clean: Tensor, noise: Tensor, snr: Scalar,
                 rms_target: Scalar, rir: tp.Optional[Tensor] = None
                 ) -> tp.Tuple[Tensor, Tensor, Tensor]:
        """clean/noise: [B, T] float32; snr/rms_target: host scalars;
        rir: optional [B, T_rir]."""
        if rir is not None:
            clean = batch_rir_conv(clean, rir)
        # host scalars stay 0-dim CPU tensors: no copy to the device
        snr = torch.as_tensor(snr, dtype=torch.float32)
        rms_target = torch.as_tensor(rms_target, dtype=torch.float32)
        if self.segmental_snr:
            rms_clean, mask = self.active_rms(clean)
            scale = rms_clean / self.rms_dataloader * 10.0 ** (-snr / 20.0)
            noise = torch.where(mask, noise * scale, noise)
        else:
            rms_clean = torch.sqrt(torch.mean(torch.square(clean), 1,
                                              keepdim=True))
            scale = rms_clean / self.rms_dataloader * 10.0 ** (-snr / 20.0)
            noise = noise * scale
        noisy = clean + noise
        return self._normalize_out(clean, noise, noisy, rms_target)


def batch_rir_conv(x: Tensor, rir: Tensor) -> Tensor:
    """Per-item full causal convolution x[b] * rir[b], cut to len(x): an FFT
    convolution at the next power of two of the full length."""
    t = x.shape[1]
    n = t + rir.shape[1] - 1
    nfft = 1 << (n - 1).bit_length()
    spec = torch.fft.rfft(x, n=nfft) * torch.fft.rfft(rir, n=nfft)
    return torch.fft.irfft(spec, n=nfft)[:, :t].to(x.dtype)


class DynamicBatchLPF:
    """Per-item random sinc low-pass for 48 kHz bandwidth augmentation.

    Each item is low-passed with probability p_lpf by a hann-windowed sinc
    whose cutoff is a random target Nyquist scaled by alpha ~ U(0.95, 1);
    clean and noisy get the same per-item kernel so the pair stays aligned.
    Items without the low-pass get a unit delta, so the device call has one
    shape: the host draws a [B, K] kernel bank (`sample_kernels`) and the
    device applies one grouped conv.
    """

    def __init__(self, sampling_rate: int = 48000, kernel_size: int = 127,
                 p_lpf: float = 0.0, window: str = "hann",
                 target_sr_list: tp.Sequence[int] = (8000, 16000, 22050,
                                                     24000, 32000, 44100)):
        assert kernel_size % 2 == 1, "kernel must be odd (symmetric FIR)"
        assert window == "hann"
        self.sr = sampling_rate
        self.p_lpf = p_lpf
        self.kernel_size = kernel_size
        self.nyquist_angular = np.asarray(
            [sr_t / sampling_rate for sr_t in target_sr_list], np.float64)
        half = kernel_size // 2
        self.n_grid = np.arange(-half, half + 1, dtype=np.float64)
        # periodic hann, as torch.hann_window
        k = np.arange(kernel_size, dtype=np.float64)
        self.window = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / kernel_size)
        self.delta = np.zeros(kernel_size, np.float32)
        self.delta[half] = 1.0

    def sample_kernels(self, batch_size: int,
                       rng: tp.Optional[np.random.Generator] = None
                       ) -> np.ndarray:
        """[B, K] kernel bank; identity rows where no low-pass applies."""
        r = rng or np.random.default_rng()
        out = np.tile(self.delta, (batch_size, 1))
        if self.p_lpf <= 0.0:
            return out
        n_lpf = int((r.random(batch_size) < self.p_lpf).sum())
        if n_lpf == 0:
            return out
        idx = r.integers(0, len(self.nyquist_angular), n_lpf)
        alpha = r.uniform(0.95, 1.0, n_lpf)
        cutoffs = (self.nyquist_angular[idx] * alpha)[:, None]
        h = cutoffs * np.sinc(cutoffs * self.n_grid[None, :]) * self.window
        h = h / h.sum(axis=1, keepdims=True)  # unit DC gain
        out[:n_lpf] = h.astype(np.float32)
        return out

    def __call__(self, wav: Tensor, kernels: np.ndarray) -> Tensor:
        """wav: [B, T], kernels: [B, K] -> filtered [B, T]: one conv over
        the [1, B, T] view with groups = B (a cross-correlation, as XLA's
        convolution)."""
        b = wav.shape[0]
        k = torch.as_tensor(kernels, dtype=wav.dtype,
                            device=wav.device)[:, None, :]  # [B, 1, K]
        return F.conv1d(wav[None], k, padding=self.kernel_size // 2,
                        groups=b)[0]
