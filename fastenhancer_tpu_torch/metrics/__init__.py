"""Objective metrics and the in-training aggregator.

A copy of fastenhancer_tpu/metrics/__init__.py (the port imports nothing of
the JAX package), without the external-model metrics:

  * SISDR — numpy, exact formula;
  * STOI/ESTOI — own implementation (metrics/stoi.py);
  * PESQ — via the `pesq` C library when installed, else the built-in
    native ITU-T P.862 implementation (metrics/pesq_native.py).

`Metrics` keeps the submit/retrieve contract: submit batches during the
valid loop, retrieve drains and tracks the best epoch; state_dict persists
the best values in checkpoints. With the `pesq` library, PESQ jobs go to a
process pool started with `spawn` (a forked child of a process that has
started CUDA must not touch it, and spawn needs no such care); the native
implementation runs inline.
"""
from __future__ import annotations

import typing as tp
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .stoi import stoi, estoi
from ..data.audio_io import resample

try:
    from pesq import pesq as _pesq_fn
    _PESQ_PROVIDER = "pesq-lib"
except ImportError:
    # native ITU-T P.862 implementation (metrics/pesq_native.py): the full
    # pipeline with formula-derived tables — certified scores still require
    # the `pesq` C library, which is preferred automatically when installed
    from .pesq_native import pesq as _pesq_fn
    _PESQ_PROVIDER = "p862-native"


def sisdr(estimate: np.ndarray, reference: np.ndarray,
          eps: float = 1e-8) -> float:
    """Scale-invariant SDR in dB."""
    est = np.asarray(estimate, np.float64)
    ref = np.asarray(reference, np.float64)
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    alpha = (est * ref).sum() / (np.square(ref).sum() + eps)
    target = alpha * ref
    noise = est - target
    return float(10.0 * np.log10(
        (np.square(target).sum() + eps) / (np.square(noise).sum() + eps)))


def pesq_wb(clean: np.ndarray, enhanced: np.ndarray, sr: int) -> float:
    """Wideband PESQ (ITU-T P.862.2) MOS-LQO at 16 kHz.

    Uses the `pesq` C library when installed; otherwise the native P.862
    implementation (see metrics/pesq_native.py docstring for its documented
    deviations). `pesq_provider()` reports which one is active.
    """
    if sr != 16_000:
        clean = resample(np.asarray(clean, np.float32), sr, 16_000)
        enhanced = resample(np.asarray(enhanced, np.float32), sr, 16_000)
    return float(_pesq_fn(16_000, clean, enhanced, "wb"))


def have_pesq() -> bool:
    return _pesq_fn is not None


def pesq_provider() -> str:
    """'pesq-lib' (certified C library) or 'p862-native' (built-in)."""
    return _PESQ_PROVIDER


def _pesq_job(args):
    clean, enhanced = args
    try:
        return float(_pesq_fn(16_000, clean, enhanced, "wb"))
    except Exception:
        # both providers can reject degenerate items (too short / silent /
        # no detected utterance); score what scores, skip the rest
        return float("nan")


class Metrics:
    """In-training PESQ/STOI aggregator.

    With the `pesq` library PESQ runs on a process pool (it is
    single-threaded C); the native PESQ and STOI run inline. Under several
    ranks each rank submits its own rows and retrieves its own means, in
    step with the others (every rank runs the same PESQ batches); the
    training wrapper averages them over the ranks
    (`wrappers/ns.py::_merge_across_hosts`).
    """

    def __init__(self, num_workers: int = 8, sr: int = 16_000,
                 pesq: bool = True, stoi: bool = True):
        self.sr = sr
        self.want_pesq = pesq and have_pesq()
        self.want_stoi = stoi
        if self.want_pesq and _PESQ_PROVIDER != "pesq-lib":
            print("[metrics] using the native P.862 implementation "
                  "(install `pesq` for certified scores)")
        self.num_workers = num_workers
        self._pool: tp.Optional[ProcessPoolExecutor] = None
        self._futures: tp.List = []
        self._pesq_vals: tp.List[float] = []
        self._stoi_sum = 0.0
        self._n_stoi = 0
        self.best = {"pesq": 0.0, "stoi": 0.0, "pesq_epoch": -1,
                     "stoi_epoch": -1}

    def initialize(self) -> None:
        self._futures = []
        self._pesq_vals = []
        self._stoi_sum = 0.0
        self._n_stoi = 0

    def submit(self, clean: np.ndarray, enhanced: np.ndarray,
               wav_len: tp.Optional[np.ndarray] = None) -> None:
        """clean/enhanced: [B, T] float arrays; wav_len: [B] valid lengths."""
        clean = np.asarray(clean, np.float32)
        enhanced = np.asarray(enhanced, np.float32)
        for i in range(clean.shape[0]):
            n = int(wav_len[i]) if wav_len is not None else clean.shape[1]
            c, e = clean[i, :n], enhanced[i, :n]
            if self.sr != 16_000:
                c16 = resample(c, self.sr, 16_000)
                e16 = resample(e, self.sr, 16_000)
            else:
                c16, e16 = c, e
            if self.want_pesq:
                if _PESQ_PROVIDER == "pesq-lib":
                    # the C library is slow + single-threaded: fan out to a
                    # process pool
                    if self._pool is None:
                        self._pool = ProcessPoolExecutor(
                            self.num_workers,
                            mp_context=multiprocessing.get_context("spawn"))
                    self._futures.append(
                        self._pool.submit(_pesq_job, (c16, e16)))
                else:
                    # native numpy implementation: fast enough inline
                    self._pesq_vals.append(_pesq_job((c16, e16)))
            if self.want_stoi:
                self._stoi_sum += stoi(c, e, self.sr)
                self._n_stoi += 1

    def retrieve(self, epoch: int) -> tp.Dict[str, float]:
        out: tp.Dict[str, float] = {}
        if self.want_pesq and (self._futures or self._pesq_vals):
            drained = self._pesq_vals + [f.result() for f in self._futures]
            vals = [v for v in drained if np.isfinite(v)]
            # no key at all when every item was unscorable: MOS-LQO has no
            # meaningful zero, and a fake 0.0 would pollute TB/best-tracking
            if vals:
                out["metrics/pesq"] = float(np.mean(vals))
            if vals and out["metrics/pesq"] > self.best["pesq"]:
                self.best["pesq"] = out["metrics/pesq"]
                self.best["pesq_epoch"] = epoch
        if self.want_stoi and self._n_stoi:
            out["metrics/stoi"] = self._stoi_sum / self._n_stoi
            if out["metrics/stoi"] > self.best["stoi"]:
                self.best["stoi"] = out["metrics/stoi"]
                self.best["stoi_epoch"] = epoch
        self._futures = []
        self._pesq_vals = []
        return out

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return dict(self.best)

    def load_state_dict(self, sd: tp.Optional[tp.Dict[str, tp.Any]]) -> None:
        if sd:
            self.best.update(sd)

    def print(self) -> str:
        return (f"  best PESQ {self.best['pesq']:.3f}@{self.best['pesq_epoch']}"
                f"  best STOI {self.best['stoi']:.4f}@{self.best['stoi_epoch']}")


__all__ = ["sisdr", "stoi", "estoi", "pesq_wb", "have_pesq",
           "pesq_provider", "Metrics"]
