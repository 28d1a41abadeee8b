"""Training losses as functions on tensors.

Counterpart of fastenhancer_tpu/losses.py. Each item loss maps
(prediction, target) to a [B] tensor of per-item values (`pesq` is
pesq_loss.py's, fed (target, prediction) as the JAX package does);
`<name>_loss` is the batch mean of `<name>_items`. `Losses` takes the
config's {name: {weight, ...}} dict, weights and sums them, and keeps the
epoch's running sums (`initialize`, `accumulate`, `get`, `print`,
`reduce`).
"""
from __future__ import annotations

import math
import typing as tp

import torch

from . import parallel
from .functional import STFTConfig, compressed_stft
from .pesq_loss import PESQLoss

Tensor = torch.Tensor


def _item_mean(x: Tensor) -> Tensor:
    """Mean over all non-batch axes -> [B]."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def si_snr_items(wav_hat: Tensor, wav: Tensor, eps: float = 1e-7) -> Tensor:
    """Per-item negative SI-SNR in dB, [B], with the reference's eps
    placement inside the log10 and the denominator."""
    s1_s2 = (wav_hat * wav).sum(dim=-1, keepdim=True)
    s2_s2 = (wav * wav).sum(dim=-1, keepdim=True)
    s_target = s1_s2 / (s2_s2 + eps) * wav
    e_noise = wav_hat - s_target
    target_norm = (s_target * s_target).sum(dim=-1, keepdim=True)
    noise_norm = (e_noise * e_noise).sum(dim=-1, keepdim=True)
    snr = torch.log10(target_norm / (noise_norm + eps) + eps)
    return -10.0 * _item_mean(snr)


def si_snr_loss(wav_hat: Tensor, wav: Tensor, eps: float = 1e-7) -> Tensor:
    return si_snr_items(wav_hat, wav, eps).mean()


def wav_l1_items(wav_hat: Tensor, wav: Tensor) -> Tensor:
    return _item_mean((wav_hat - wav).abs())


def wav_l1_loss(wav_hat: Tensor, wav: Tensor) -> Tensor:
    return wav_l1_items(wav_hat, wav).mean()


def mag_mse_items(spec_hat: Tensor, spec: Tensor) -> Tensor:
    """Per-item MSE of the magnitudes of [..., 2] re/im specs. The sqrt is
    floored at a normal float (1e-30) so exactly-zero bins have finite
    gradients."""
    m1 = spec_hat.square().sum(-1).clamp_min(1e-30).sqrt()
    m2 = spec.square().sum(-1).clamp_min(1e-30).sqrt()
    return _item_mean((m1 - m2).square())


def mag_mse_loss(spec_hat: Tensor, spec: Tensor) -> Tensor:
    return mag_mse_items(spec_hat, spec).mean()


def complex_mse_items(spec_hat: Tensor, spec: Tensor) -> Tensor:
    return _item_mean((spec_hat - spec).square())


def complex_mse_loss(spec_hat: Tensor, spec: Tensor) -> Tensor:
    return complex_mse_items(spec_hat, spec).mean()


def _anti_wrap(x: Tensor) -> Tensor:
    two_pi = 2.0 * math.pi
    return (x - torch.round(x / two_pi) * two_pi).abs()


def phase_items(spec_hat: Tensor, spec: Tensor) -> Tensor:
    """Per-item anti-wrapped instantaneous-phase + group-delay + IAF losses
    of [B, F, T, 2] specs."""
    ph_hat = torch.atan2(spec_hat[..., 1], spec_hat[..., 0])
    ph = torch.atan2(spec[..., 1], spec[..., 0])
    ip = _item_mean(_anti_wrap(ph - ph_hat))
    gd = _item_mean(_anti_wrap(torch.diff(ph, dim=1)
                               - torch.diff(ph_hat, dim=1)))
    iaf = _item_mean(_anti_wrap(torch.diff(ph, dim=2)
                                - torch.diff(ph_hat, dim=2)))
    return ip + gd + iaf


def phase_loss(spec_hat: Tensor, spec: Tensor) -> Tensor:
    return phase_items(spec_hat, spec).mean()


class ConsistencyLoss:
    """Re-STFT MSE: both wavs analysed again through a compressed STFT (the
    training wrapper fills in the model's STFT settings)."""

    def __init__(self, compression: float = 1.0, n_fft: int = 512,
                 hop_size: int = 256, win_size: tp.Optional[int] = None,
                 win_type: tp.Optional[str] = None):
        self.cfg = STFTConfig(n_fft=n_fft, hop_size=hop_size,
                              win_size=win_size, win_type=win_type)
        self.compression = compression

    def items(self, wav_hat: Tensor, wav: Tensor) -> Tensor:
        spec_hat = compressed_stft(wav_hat, self.cfg, self.compression)
        spec = compressed_stft(wav, self.cfg, self.compression)
        return _item_mean((spec_hat - spec).square())


def _make(name: str, kwargs: tp.Dict[str, tp.Any]
          ) -> tp.Tuple[str, tp.Callable[[Tensor, Tensor], Tensor]]:
    """name -> (input type "wav" or "spec", per-item fn returning [B])."""
    if name == "si_snr":
        eps = kwargs.get("eps", 1e-7)
        return "wav", lambda a, b: si_snr_items(a, b, eps)
    if name == "wav_l1":
        return "wav", wav_l1_items
    if name == "mag_mse":
        return "spec", mag_mse_items
    if name == "complex_mse":
        return "spec", complex_mse_items
    if name == "phase":
        return "spec", phase_items
    if name == "consistency":
        return "wav", ConsistencyLoss(**kwargs).items
    if name == "pesq":
        fn = PESQLoss(sample_rate=kwargs.get("sample_rate", 16_000))
        return "wav", lambda a, b: fn.items(b, a)  # (ref, deg), as JAX
    raise ValueError(f"unknown loss: {name}")


class Losses:
    """Weighted losses from a config dict {name: {weight, ...}}."""

    def __init__(self, losses_cfg: tp.Mapping[str, tp.Mapping[str, tp.Any]]):
        self.weights: tp.Dict[str, float] = {}
        self.fns: tp.Dict[str, tp.Tuple[str, tp.Callable]] = {}
        for name, kwargs in dict(losses_cfg).items():
            kw = dict(kwargs)
            self.weights[name] = float(kw.pop("weight"))
            self.fns[name] = _make(name, kw)
        self.initialize()

    def calculate(self, wav_hat: Tensor, spec_hat: Tensor, wav: Tensor,
                  spec: Tensor, row_mask: tp.Optional[Tensor] = None
                  ) -> tp.Tuple[Tensor, tp.Dict[str, Tensor]]:
        """(total, {name: value}). row_mask [B] (1 real, 0 zero-padded row)
        restricts the batch means to real items. Padded rows are first
        replaced by row 0 (always real: padding is appended), detached, so
        every item loss stays finite in value and gradient (atan2(0, 0) in
        the phase loss has a NaN derivative, and NaN * 0 would poison the
        masked mean's backward); the mask then zeroes both. Under several
        ranks each value is this rank's share of the global mean: its row
        sum over the count of real rows of every rank, so the ranks'
        values add up to the mean over the global batch."""
        if row_mask is None and parallel.world() > 1:
            row_mask = wav.new_ones(wav.shape[0])
        if row_mask is not None:
            w = row_mask.float()
            denom = parallel.all_reduce_sum(w.sum().detach()).clamp_min(1.0)
            real = w > 0

            def safe(x: Tensor) -> Tensor:
                m = real.reshape((-1,) + (1,) * (x.ndim - 1))
                return torch.where(m, x, x[:1].detach())

            wav_hat, wav = safe(wav_hat), safe(wav)
            spec_hat, spec = safe(spec_hat), safe(spec)
        total = wav.new_zeros(())
        out: tp.Dict[str, Tensor] = {}
        for name, (input_type, fn) in self.fns.items():
            items = (fn(wav_hat, wav) if input_type == "wav"
                     else fn(spec_hat, spec))
            val = (items.mean() if row_mask is None
                   else (items * w).sum() / denom)
            out[name] = val
            total = total + self.weights[name] * val
        return total, out

    # -- host-side epoch bookkeeping ------------------------------------------

    def initialize(self) -> None:
        self._sums: tp.Dict[str, tp.Any] = {n: 0.0 for n in self.fns}
        self._n_items = 0

    def accumulate(self, per_loss: tp.Mapping[str, tp.Any],
                   batch_size: int) -> None:
        """Running sums. Device scalars are added on the device, so the step
        loop does not wait for the card; get and reduce read them."""
        for n, v in per_loss.items():
            if isinstance(v, Tensor):
                v = v.detach()
            self._sums[n] = self._sums[n] + v * batch_size
        self._n_items += batch_size

    def get(self, key: str) -> float:
        if key not in self._sums or self._n_items == 0:
            return 0.0
        return float(self._sums[key]) / self._n_items

    def print(self) -> str:
        """The running means as one line, `  name: 1.23e-02` a loss. It
        reads the device sums, so it waits for the card: the train loop's
        per-step progress line leaves it out."""
        return "".join(
            f"  {n}: {float(s) / max(self._n_items, 1):8.2e}"
            for n, s in self._sums.items())

    def reduce(self) -> tp.Dict[str, float]:
        """Epoch means keyed 'loss/<name>'."""
        return {f"loss/{n}": self.get(n) for n in self.fns}
