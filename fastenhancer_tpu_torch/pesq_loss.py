"""Differentiable PESQ-shaped training loss, in PyTorch.

Counterpart of fastenhancer_tpu/pesq_loss.py, a re-derivation of ITU-T
P.862's structure (not a clone of the reference's `torch_pesq` package):

  1. 32 ms / 50% overlap Hann STFT power spectrum;
  2. integration into 49 Bark bands;
  3. partial frequency and gain equalization between the reference and
     the degraded Bark spectra;
  4. Zwicker-law loudness over an absolute hearing threshold;
  5. symmetric and asymmetric disturbances with the masking deadzone,
     saturated at 45, L2 over Bark, RMS over time;
  6. MOS = 4.5 - 0.1 d_sym - 0.0309 d_asym, loss = (4.5 - MOS) / 3.6.

The tables (Bark matrix, window, threshold) are built in numpy at
construction and moved once to each device the loss meets. Two choices
keep the gradient equal to JAX's where JAX's is finite: the power is
re^2 + im^2 (the same value as |X|^2, whose derivative at an exactly zero
bin is 0/0), and every max, min and clip is an elementwise
maximum/minimum, which splits the gradient at a tie as jnp.maximum does
(torch.clamp gives it all to the input).
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

Tensor = torch.Tensor


def _bark_bands(n_freq: int, sr: int, n_bark: int = 49) -> np.ndarray:
    """[n_bark, n_freq] rectangular Bark integration matrix (each row the
    mean over its band's bins)."""
    f = np.linspace(0, sr / 2, n_freq)
    bark = 6.0 * np.arcsinh(f / 600.0)  # Wang/P.862-style Bark warp
    edges = np.linspace(bark[0], bark[-1], n_bark + 1)
    mat = np.zeros((n_bark, n_freq), np.float32)
    for i in range(n_bark):
        sel = (bark >= edges[i]) & (bark < edges[i + 1])
        if not sel.any():
            sel[np.argmin(np.abs(bark - edges[i]))] = True
        mat[i, sel] = 1.0 / sel.sum()
    return mat


def _abs_threshold(sr: int, n_bark: int = 49) -> np.ndarray:
    """Absolute hearing threshold per band, power (simplified P.862 curve)."""
    f_centers = np.linspace(0, sr / 2, n_bark)
    thr_db = 3.64 * (f_centers / 1000 + 1e-2) ** -0.8 \
        - 6.5 * np.exp(-0.6 * ((f_centers / 1000) - 3.3) ** 2) \
        + 1e-3 * (f_centers / 1000) ** 4
    return (10.0 ** (np.clip(thr_db, -10, 96) / 10.0)).astype(np.float32)


def _clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """jnp.clip's gradient: minimum(maximum(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _sat45(v: Tensor) -> Tensor:
    """45 tanh(v / 45): P.862's clip at 45, saturating smoothly."""
    return 45.0 * torch.tanh(v / 45.0)


class PESQLoss:
    """items(ref, deg) -> [B] in [0, ~1.6] (0: indistinguishable)."""

    N_FFT = 512
    HOP = 256

    def __init__(self, sample_rate: int = 16_000, factor: float = 1.0):
        if sample_rate != 16_000:
            raise ValueError("the PESQ loss is defined at 16 kHz, not "
                             f"{sample_rate}")
        self.sr = sample_rate
        self.factor = factor
        window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(self.N_FFT)
                                     / self.N_FFT)).astype(np.float32)
        self._np_tables = {
            "bark_t": np.ascontiguousarray(
                _bark_bands(self.N_FFT // 2 + 1, sample_rate).T),
            "window": window,
            "thr": _abs_threshold(sample_rate)}
        self._tables: tp.Dict[torch.device, tp.Dict[str, Tensor]] = {}

    def tables(self, device: torch.device) -> tp.Dict[str, Tensor]:
        """The tables on `device` (moved there once)."""
        if device not in self._tables:
            self._tables[device] = {k: torch.from_numpy(v).to(device)
                                    for k, v in self._np_tables.items()}
        return self._tables[device]

    def _bark_spectrum(self, wav: Tensor, tab: tp.Dict[str, Tensor]
                       ) -> Tensor:
        """[B, T] -> [B, frames, 49] Bark power spectrum."""
        frames = wav.unfold(-1, self.N_FFT, self.HOP) * tab["window"]
        spec = torch.fft.rfft(frames, dim=-1)
        power = spec.real.square() + spec.imag.square()
        return power @ tab["bark_t"]

    def __call__(self, ref: Tensor, deg: Tensor) -> Tensor:
        """ref, deg: [B, T] waveforms of one length -> the batch mean."""
        return self.items(ref, deg).mean()

    def items(self, ref: Tensor, deg: Tensor) -> Tensor:
        """Per-item loss [B], float32."""
        ref, deg = ref.float(), deg.float()
        tab = self.tables(ref.device)

        def norm(x: Tensor) -> Tensor:
            # level alignment: both to a common active power
            p = x.square().mean(dim=-1, keepdim=True)
            return x * torch.rsqrt(torch.maximum(p, p.new_tensor(1e-12))) \
                * 0.03

        pb_ref = self._bark_spectrum(norm(ref), tab) * 1e4   # [B, N, 49]
        pb_deg = self._bark_spectrum(norm(deg), tab) * 1e4

        # partial frequency compensation of the reference (+-20 dB)
        fnum = pb_deg.mean(dim=1, keepdim=True) + 1e3 * 1e-4
        fden = pb_ref.mean(dim=1, keepdim=True) + 1e3 * 1e-4
        pb_ref = pb_ref * _clip(fnum / fden, 1e-2, 1e2)

        # partial gain equalization of the degraded signal (one scalar an
        # item over time and bands)
        num = pb_ref.mean(dim=(1, 2), keepdim=True) + 1e3 * 1e-4
        den = pb_deg.mean(dim=(1, 2), keepdim=True) + 1e3 * 1e-4
        pb_deg = pb_deg * _clip(num / den, 3e-4, 5.0)

        thr = tab["thr"]

        def loudness(p: Tensor) -> Tensor:  # Zwicker
            s = (thr / 0.5) ** 0.23 * ((0.5 + 0.5 * p / thr) ** 0.23 - 1.0)
            return torch.maximum(s, s.new_tensor(0.0)) * 32.0

        l_ref, l_deg = loudness(pb_ref), loudness(pb_deg)

        # disturbance with the masking deadzone
        d = l_deg - l_ref
        m = 0.25 * torch.minimum(l_ref, l_deg)
        d = torch.sign(d) * torch.maximum(d.abs() - m, d.new_tensor(0.0))

        # symmetric: L2 over Bark per frame, saturated, RMS over frames
        d_sym = torch.sqrt(d.square().mean(dim=-1) + 1e-12)
        d_sym = torch.sqrt(_sat45(d_sym).square().mean(dim=-1) + 1e-12)

        # asymmetric: additive distortion penalized harder
        ratio = (pb_deg + 50.0 * 1e-4) / (pb_ref + 50.0 * 1e-4)
        asym = _clip(ratio ** 1.2, 0.0, 12.0)
        asym = torch.where(asym < 3.0, torch.zeros_like(asym), asym)
        d_asym = (d.abs() * asym).sum(dim=-1) / 49.0
        d_asym = torch.sqrt(_sat45(d_asym).square().mean(dim=-1) + 1e-12)

        mos = 4.5 - 0.1 * d_sym - 0.0309 * d_asym
        return self.factor * (4.5 - mos) / 3.6
