"""Active-segment RMS: the plain version and the wrapper of the hand-written
CUDA kernel (csrc/segmental_rms.cu).

Counterpart of fastenhancer_tpu/ops/segmental_rms.py. Split each row into
`window_ms` frames, keep the frames whose mean power exceeds
max(max_power * 10^(rel/10), 10^(abs/10)), and return the sqrt of the mean
power of the kept frames ([B, 1, 1]; +inf when none is kept). A row
shorter than one frame gives the RMS of the whole row.

* `segmental_rms` is the plain PyTorch version (the JAX package's XLA form):
  sums in float32 whatever the input type, the result in the input's type,
  as the kernel does.
* `segmental_rms_fused` is the wrapper, the counterpart of
  `segmental_rms_pallas`: it calls the op
  `torch.ops.fastenhancer.segmental_rms` (ops/_library.py), whose CPU
  implementation is the plain version (`cpu_impl`) and whose CUDA one
  launches the kernel or raises (`cuda_impl`); nothing falls back.
  `segmental_rms_fused.launches` counts kernel launches, in `cuda_impl`. The kernel runs
  a cluster of `cluster_size(B)` thread blocks per row, each on the
  frames `frame_range` deals it.

What bounds the kernel on the H100, and what its design does about it, is
in the note at the top of csrc/segmental_rms.cu.
"""
from __future__ import annotations

import ctypes
import typing as tp

import torch

from . import _build

Tensor = torch.Tensor

# wav, out; batch, len, win, cluster; rel_ratio, abs_floor; the stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p]
_SMS = 132  # the H100 SXM's streaming multiprocessors
_CLUSTERS = (8, 4, 2, 1)  # 8 is the largest portable cluster


def cluster_size(batch: int) -> int:
    """Thread blocks a row: the largest of 8, 4, 2 and 1 that keeps the
    B * K blocks within one wave of the 132 SMs (at least 1)."""
    return next((k for k in _CLUSTERS if batch * k <= _SMS), 1)


def frame_range(frames: int, cluster: int, rank: int) -> range:
    """The frames block `rank` of a row's cluster reads (the kernel's
    [n rank / K, n (rank + 1) / K)): contiguous, every frame in one."""
    return range(frames * rank // cluster, frames * (rank + 1) // cluster)


def _prep(wav: Tensor, sr: int, window_ms: int) -> tp.Tuple[Tensor, int, int]:
    wav = wav.reshape(wav.shape[0], -1)
    win = int(sr * window_ms / 1000)
    return wav, win, wav.shape[-1] // win


def _thresholds(relative_threshold_db: float,
                absolute_threshold_db: tp.Optional[float]
                ) -> tp.Tuple[float, float]:
    """(rel_ratio, abs_floor); no absolute threshold is a floor of 0."""
    abs_floor = (10.0 ** (absolute_threshold_db / 10.0)
                 if absolute_threshold_db is not None else 0.0)
    return 10.0 ** (relative_threshold_db / 10.0), abs_floor


def segmental_rms(wav: Tensor, sr: int = 16_000, window_ms: int = 100,
                  relative_threshold_db: float = -25.0,
                  absolute_threshold_db: tp.Optional[float] = -50.0
                  ) -> Tensor:
    """[B, T] (or [B, 1, T]) -> [B, 1, 1] active-segment RMS, plain."""
    in_dtype = wav.dtype
    wav, win, n = _prep(wav, sr, window_ms)
    x = wav.float()
    if n == 0:
        return x.square().mean(dim=-1).sqrt().to(in_dtype)[:, None, None]
    seg_pow = x[:, :n * win].square().reshape(x.shape[0], n, win).mean(-1)
    rel_ratio, abs_floor = _thresholds(relative_threshold_db,
                                       absolute_threshold_db)
    threshold = (seg_pow.amax(dim=-1, keepdim=True) * rel_ratio
                 ).clamp_min(abs_floor)
    active = seg_pow > threshold
    n_active = active.sum(dim=-1)
    mean_pow = (seg_pow * active).sum(dim=-1) / n_active.clamp_min(1)
    rms = torch.where(n_active > 0, mean_pow.sqrt(),
                      torch.full_like(mean_pow, float("inf")))
    return rms.to(in_dtype)[:, None, None]


def smem_bytes(length: int, win: int) -> int:
    """Shared memory of one thread block: the row's frame powers, float32
    (rank 0's are read)."""
    return 4 * (length // win)


def segmental_rms_fused(wav: Tensor, sr: int = 16_000, window_ms: int = 100,
                        relative_threshold_db: float = -25.0,
                        absolute_threshold_db: tp.Optional[float] = -50.0
                        ) -> Tensor:
    """segmental_rms as one kernel launch, a cluster of thread blocks per
    row.

    wav: [B, T] (or [B, 1, T]), float32 or bfloat16 -> [B, 1, 1] in wav's
    dtype. The op `torch.ops.fastenhancer.segmental_rms`
    (ops/_library.py): on the CPU the plain version; on a CUDA device it
    launches the kernel (building it on first use) and raises if it
    cannot."""
    _build.check_device(wav)
    return torch.ops.fastenhancer.segmental_rms(
        wav, sr, window_ms, relative_threshold_db, absolute_threshold_db)


def cpu_impl(wav: Tensor, sr: int, window_ms: int,
             relative_threshold_db: float,
             absolute_threshold_db: tp.Optional[float]) -> Tensor:
    """The op's CPU implementation: the plain version."""
    return segmental_rms(wav, sr, window_ms, relative_threshold_db,
                         absolute_threshold_db)


def fake_impl(wav: Tensor, sr: int, window_ms: int,
              relative_threshold_db: float,
              absolute_threshold_db: tp.Optional[float]) -> Tensor:
    """The op's shape and type: [B, 1, 1] in wav's dtype."""
    return wav.new_empty(wav.shape[0], 1, 1)


def cuda_impl(wav: Tensor, sr: int, window_ms: int,
              relative_threshold_db: float,
              absolute_threshold_db: tp.Optional[float]) -> Tensor:
    """The op's CUDA implementation: one launch of the kernel, counted in
    segmental_rms_fused.launches."""
    wav, win, _ = _prep(wav, sr, window_ms)
    b, length = wav.shape
    if b == 0:
        raise ValueError("need B >= 1")
    smem = smem_bytes(length, win)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f"T={length} has {length // win} frames; the kernel holds at "
            f"most {_build.MAX_SMEM_BYTES // 4}")
    fn = _build.entry("segmental_rms", wav.dtype, _ARGTYPES)
    wav = wav.contiguous()
    out = torch.empty(b, 1, 1, dtype=wav.dtype, device=wav.device)
    rel_ratio, abs_floor = _thresholds(relative_threshold_db,
                                       absolute_threshold_db)
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        err = fn(wav.data_ptr(), out.data_ptr(), b, length, win,
                 cluster_size(b), rel_ratio, abs_floor, stream)
    _build.check_launch("segmental_rms", err)
    segmental_rms_fused.launches += 1
    return out


segmental_rms_fused.launches = 0
