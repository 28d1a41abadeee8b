"""TensorBoard summaries of the training loop.

Counterpart of fastenhancer_tpu/utils/summarize.py, written through the
port's own event-file writer (`utils/event_file.py`; the card's machine has
no tensorboardX, matplotlib or PIL). `summarize` writes the summary dicts
the wrappers return, with the JAX package's semantics: histograms drop
non-finite values (and are skipped when none is left), audio above a peak
of 1 is peak-normalised, then written as stdlib-`wave` PCM16 bytes.

One divergence: `plot_spectrogram_to_numpy` renders the array alone, each
value a pixel coloured by a fixed table (a polynomial fit of matplotlib's
viridis), the lowest frequency at the bottom, with no axes or colorbar.
"""
from __future__ import annotations

import typing as tp

import numpy as np

from .tree import tree_paths

# viridis as a degree-6 polynomial per channel (coefficients of t^0..t^6)
_VIRIDIS = np.array([
    [0.2777273272234177, 0.005407344544966578, 0.3340998053353061],
    [0.1050930431085774, 1.404613529898575, 1.384590162594685],
    [-0.3308618287255563, 0.214847559468213, 0.09509516302823659],
    [-4.634230498983486, -5.799100973351585, -19.33244095627987],
    [6.228269936347081, 14.17993336680509, 56.69055260068105],
    [4.776384997670288, -13.74514537774601, -65.35303263337234],
    [-5.435455855934631, 4.645852612178535, 26.3124352495832]])


def _colormap_table() -> np.ndarray:
    t = np.linspace(0.0, 1.0, 256)[:, None]
    rgb = sum(c * t ** k for k, c in enumerate(_VIRIDIS))
    return np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


COLORMAP = _colormap_table()  # [256, 3] uint8


def plot_spectrogram_to_numpy(spec: np.ndarray) -> np.ndarray:
    """[F, T] log-magnitude -> [F, T, 3] HWC uint8: the values scaled to
    the table over their own min..max, row 0 the highest frequency."""
    spec = np.asarray(spec, np.float64)
    lo, hi = np.nanmin(spec), np.nanmax(spec)
    scaled = (spec - lo) / (hi - lo) if hi > lo else np.zeros_like(spec)
    idx = np.nan_to_num(scaled * 255.0, nan=0.0).round().astype(np.int64)
    return COLORMAP[np.clip(idx, 0, 255)[::-1]]


def _host(v: tp.Any) -> np.ndarray:
    """A tensor (any device or dtype) or array as a float32 host array."""
    if hasattr(v, "detach"):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v)


def summarize(
    writer,
    epoch: int,
    sampling_rate: int,
    scalars: tp.Optional[tp.Dict[str, float]] = None,
    hists: tp.Optional[tp.Dict[str, tp.Any]] = None,
    audios: tp.Optional[tp.Dict[str, np.ndarray]] = None,
    specs: tp.Optional[tp.Dict[str, np.ndarray]] = None,
) -> None:
    """Write one epoch's summaries to `writer` (a utils.event_file
    EventWriter) at step `epoch`."""
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, v, epoch)
    for k, v in (hists or {}).items():
        v = _host(v).ravel()
        v = v[np.isfinite(v)]
        if v.size:
            writer.add_histogram(k, v, epoch)
    for k, v in (audios or {}).items():
        v = np.asarray(_host(v), np.float32).reshape(-1)
        peak = np.abs(v).max()
        if peak > 1.0:
            v = v / peak
        writer.add_audio(k, v, epoch, sampling_rate)
    for k, v in (specs or {}).items():
        writer.add_image(k, plot_spectrogram_to_numpy(_host(v)), epoch)


def plot_param_and_grad(hists: tp.Dict[str, np.ndarray], params: tp.Any,
                        grads: tp.Any = None) -> None:
    """Every leaf of the param (and grad) tree as a host array under
    `param/<path>` (`grad/<path>`), the path's keys joined by "/"."""
    for prefix, tree in (("param", params), ("grad", grads)):
        if tree is None:
            continue
        for path, leaf in tree_paths(tree):
            hists[f"{prefix}/{'/'.join(path)}"] = _host(leaf)


__all__ = ["summarize", "plot_spectrogram_to_numpy", "plot_param_and_grad",
           "COLORMAP"]
