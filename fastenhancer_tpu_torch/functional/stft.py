"""STFT / iSTFT front end in PyTorch.

Counterpart of fastenhancer_tpu/functional/stft.py, same math and the same
dtype contract:

* offline `stft` / `istft` over whole utterances (used by `Model.forward`);
* magnitude compression `compress` / `uncompress`;
* single-hop streaming `stft_streaming_step` / `istft_streaming_step` with
  explicit rolling carries (`stream_stft` / `stream_istft` loop them over a
  whole signal), and their multi-hop forms
  `stft_streaming_chunk` / `istft_streaming_chunk` (C hops at once, one
  batched DFT over the C frames), which the models' streaming steps run,
  a single hop as C = 1.

Each transform has an `fft` form (torch.fft) and a `matmul` form (one
windowed-DFT matrix product). The DFT always runs in float32 whatever the
activation dtype: inputs are widened to float32 first and results are cast
back to the input dtype, at exactly the JAX package's points. The JAX
package pins `Precision.HIGHEST` for the DFT matmul; in PyTorch a float32
matmul is full float32 only while `torch.backends.cuda.matmul.allow_tf32`
is False, and a float32 convolution only while
`torch.backends.cudnn.allow_tf32` is False (PyTorch's default is True).
The entry points turn both off; a Python caller who wants the JAX
package's float32 calls `utils.precision.full_float32()` or sets both.

The window and DFT matrices are numpy constants computed once per config
(float64 internally) and copied to each device on first use.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Windows (numpy; copies of fastenhancer_tpu/functional/stft.py:41-99)
# ---------------------------------------------------------------------------

def make_window(win_type: tp.Optional[str], win_size: int) -> np.ndarray:
    """Analysis window (float64). Supported: None (rect), "hann" (periodic,
    torch.hann_window default), "povey", "hann-sqrt", "hamming",
    "blackman"."""
    n = np.arange(win_size, dtype=np.float64)
    if win_type is None:
        w = np.ones(win_size, dtype=np.float64)
    elif win_type == "hann":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)
    elif win_type == "povey":
        sym = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_size - 1))
        w = sym ** 0.85
    elif win_type == "hann-sqrt":
        sym = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_size - 1))
        w = np.sqrt(sym)
    elif win_type == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_size)
    elif win_type == "blackman":
        x = 2.0 * np.pi * n / win_size
        w = 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)
    else:
        raise ValueError(f"unsupported window type: {win_type}")
    return w.astype(np.float64)


def padded_window(win_type: tp.Optional[str], win_size: int,
                  n_fft: int) -> np.ndarray:
    """Window zero-padded symmetrically to n_fft (torch.stft convention)."""
    w = make_window(win_type, win_size)
    if win_size < n_fft:
        pad = n_fft - win_size
        w = np.pad(w, (pad // 2, pad - pad // 2))
    elif win_size > n_fft:
        raise ValueError(f"win_size({win_size}) > n_fft({n_fft})")
    return w


def ola_window_sq_sum(window: np.ndarray, hop: int) -> np.ndarray:
    """Steady-state overlap-added window-square sum over one frame:
    sum_k window[i + k*hop]^2, the periodic denominator of OLA synthesis."""
    n_fft = window.shape[0]
    wsq = window.astype(np.float64) ** 2
    out = np.zeros(n_fft, dtype=np.float64)
    k_max = (n_fft + hop - 1) // hop
    for k in range(-k_max, k_max + 1):
        shift = k * hop
        lo = max(0, -shift)
        hi = min(n_fft, n_fft - shift)
        if lo < hi:
            out[lo:hi] += wsq[lo + shift: hi + shift]
    return out


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """Static STFT configuration (the fields of the JAX STFTConfig)."""
    n_fft: int
    hop_size: int
    win_size: tp.Optional[int] = None
    win_type: tp.Optional[str] = "hann"
    center: bool = True
    pad_mode: str = "reflect"
    normalized: bool = False
    method: str = "fft"  # "fft" | "matmul"

    def __post_init__(self):
        if self.win_size is None:
            object.__setattr__(self, "win_size", self.n_fft)
        if self.n_fft < self.win_size:
            raise ValueError(f"n_fft({self.n_fft}) < win_size({self.win_size})")
        if self.method not in ("fft", "matmul"):
            raise ValueError(f"unsupported STFT method {self.method!r}")

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def cache_len(self) -> int:
        return self.n_fft - self.hop_size

    @functools.cached_property
    def window(self) -> np.ndarray:
        return padded_window(self.win_type, self.win_size, self.n_fft)

    @functools.cached_property
    def window_f32(self) -> np.ndarray:
        return self.window.astype(np.float32)

    @functools.cached_property
    def synthesis_window(self) -> np.ndarray:
        """window / OLA(window^2): steady-state per-frame synthesis window."""
        return (self.window / ola_window_sq_sum(self.window, self.hop_size)
                ).astype(np.float32)

    @functools.cached_property
    def dft_matrix(self) -> np.ndarray:
        """Windowed forward DFT as a matmul: [n_fft, 2*n_freq] (re then im)."""
        n = np.arange(self.n_fft, dtype=np.float64)[:, None]
        k = np.arange(self.n_freq, dtype=np.float64)[None, :]
        ang = -2.0 * np.pi / self.n_fft * n * k
        m = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
        m = self.window[:, None] * m
        if self.normalized:
            m = m / math.sqrt(self.n_fft)
        return m.astype(np.float32)

    @functools.cached_property
    def idft_matrix(self) -> np.ndarray:
        """Inverse real DFT as a matmul: [2*n_freq, n_fft] (re rows then im
        rows). Interior bins carry weight 2, bins 0 and n_fft/2 weight 1, so
        concat(Re X, Im X) @ idft_matrix == irfft(X)."""
        k = np.arange(self.n_freq, dtype=np.float64)[:, None]
        n = np.arange(self.n_fft, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi / self.n_fft * k * n
        scale = np.full((self.n_freq, 1), 2.0 / self.n_fft)
        scale[0] = 1.0 / self.n_fft
        scale[-1] = 1.0 / self.n_fft
        m = np.concatenate([scale * np.cos(ang), -scale * np.sin(ang)], axis=0)
        if self.normalized:
            m = m * math.sqrt(self.n_fft)
        return m.astype(np.float32)

    def tensor(self, name: str, device: torch.device) -> Tensor:
        """float32 tensor of the numpy constant `name` (window_f32,
        synthesis_window, dft_matrix, idft_matrix) on `device`, copied once
        per device. While a trace runs (torch.export, torch.compile) the
        tensor is made for the trace and not cached: a tensor made inside
        a trace is the trace's own (a fake tensor under torch.export), and
        a cache that outlived the trace would hand it to the next trace
        and to eager calls."""
        cache = self.__dict__.setdefault("_tensors", {})
        key = (name, torch.device(device))
        t = cache.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(getattr(self, name))
                                 ).to(device=device, dtype=torch.float32)
            if not torch.compiler.is_compiling():
                cache[key] = t
        return t


# ---------------------------------------------------------------------------
# Framing / overlap-add
# ---------------------------------------------------------------------------

def frame_signal(x: Tensor, n_fft: int, hop: int) -> Tensor:
    """[B, L] -> [B, T, n_fft] frames at stride `hop` (no padding)."""
    return x.unfold(-1, n_fft, hop)


def overlap_add(frames: Tensor, hop: int) -> Tensor:
    """[B, T, n_fft] -> [B, (T-1)*hop + n_fft] overlap-add at stride `hop`."""
    b, t, n_fft = frames.shape
    out_len = (t - 1) * hop + n_fft
    if t == 1:
        return frames[:, 0]
    if n_fft % hop == 0:
        k = n_fft // hop
        chunks = frames.reshape(b, t, k, hop)
        out = frames.new_zeros(b, t + k - 1, hop)
        for i in range(k):
            out[:, i: i + t] += chunks[:, :, i]
        return out.reshape(b, (t + k - 1) * hop)[:, :out_len]
    # col2im sums each output sample's frames in one thread, in frame
    # order: the same bits every run (an index_add_ on CUDA adds them with
    # atomics, in whatever order they land)
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop))
    return out.reshape(b, out_len)


# ---------------------------------------------------------------------------
# Offline STFT / iSTFT
# ---------------------------------------------------------------------------

def _center_pad(x: Tensor, pad: int, mode: str) -> Tensor:
    if mode == "reflect":
        return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    if mode == "constant":
        return F.pad(x, (pad, pad))
    raise ValueError(f"unsupported pad_mode {mode}")


def _dft(frames: Tensor, cfg: STFTConfig) -> tp.Tuple[Tensor, Tensor]:
    """float32 frames [..., n_fft] -> (re, im) [..., n_freq]."""
    if cfg.method == "matmul":
        # one 2-D product: frames that are an unfold view (strided rows)
        # would otherwise go to a batched product, one small GEMM (or a
        # GEMV at one frame) per row of the batch
        lead = frames.shape[:-1]
        spec = (frames.reshape(-1, frames.shape[-1])
                @ cfg.tensor("dft_matrix", frames.device))
        spec = spec.reshape(*lead, spec.shape[-1])
        return spec[..., :cfg.n_freq], spec[..., cfg.n_freq:]
    z = torch.fft.rfft(frames * cfg.tensor("window_f32", frames.device),
                       dim=-1)
    re, im = z.real, z.imag
    if cfg.normalized:
        s = 1.0 / math.sqrt(cfg.n_fft)
        re, im = re * s, im * s
    return re, im


def _idft(re: Tensor, im: Tensor, cfg: STFTConfig) -> Tensor:
    """float32 (re, im) [..., n_freq] -> frames [..., n_fft] (no window)."""
    if cfg.method == "matmul":
        return (torch.cat([re, im], dim=-1)
                @ cfg.tensor("idft_matrix", re.device))
    frames = torch.fft.irfft(torch.complex(re, im), n=cfg.n_fft, dim=-1)
    if cfg.normalized:
        frames = frames * math.sqrt(cfg.n_fft)
    return frames


def stft(x: Tensor, cfg: STFTConfig) -> Tensor:
    """Batch STFT. x: [B, L] (or [B, 1, L]) -> [B, n_freq, T, 2].

    Matches torch.stft(center=cfg.center, pad_mode=cfg.pad_mode, onesided)."""
    if x.ndim == 3:
        x = x.squeeze(1)
    in_dtype = x.dtype
    x = x.float()
    if cfg.center:
        x = _center_pad(x, cfg.n_fft // 2, cfg.pad_mode)
    frames = frame_signal(x, cfg.n_fft, cfg.hop_size)  # [B, T, n_fft]
    re, im = _dft(frames, cfg)
    out = torch.stack([re, im], dim=-1).transpose(1, 2)  # [B, n_freq, T, 2]
    if cfg.hop_size % 2 == 1:  # the torch front end clips the last frame
        out = out[:, :, :-1]
    return out.to(in_dtype)


def istft(spec: Tensor, cfg: STFTConfig,
          length: tp.Optional[int] = None) -> Tensor:
    """Batch inverse STFT. spec: [B, n_freq, T, 2] -> [B, L].

    OLA(irfft(X) * w) / OLA(w^2), trimmed by n_fft//2 on each side, as
    torch.istft(center=True)."""
    if not cfg.center:
        raise NotImplementedError("istft requires center=True")
    in_dtype = spec.dtype
    spec = spec.float()
    re = spec[..., 0].transpose(1, 2)  # [B, T, n_freq]
    im = spec[..., 1].transpose(1, 2)
    window = cfg.tensor("window_f32", spec.device)
    frames = _idft(re, im, cfg) * window
    y = overlap_add(frames, cfg.hop_size)
    t = frames.shape[1]
    out_len = (t - 1) * cfg.hop_size + cfg.n_fft
    denom = overlap_add((window * window).expand(1, t, cfg.n_fft),
                        cfg.hop_size)[0]
    denom = torch.where(denom > 1e-11, denom, torch.ones_like(denom))
    y = y / denom
    half = cfg.n_fft // 2
    y = y[:, half: out_len - half]
    if length is not None:
        y = y[:, :length]
    return y.to(in_dtype)


# ---------------------------------------------------------------------------
# Magnitude compression
# ---------------------------------------------------------------------------

def compress(spec: Tensor, compression: float, eps: float = 1.0e-5) -> Tensor:
    """x * |x|^(c-1) on [..., 2] real/imag pairs; the eps floor sits inside
    the sqrt (power domain, eps^2)."""
    if compression == 1.0:
        return spec
    power = spec.square().sum(dim=-1, keepdim=True)
    mag = power.clamp_min(eps * eps).sqrt()
    return spec * mag.pow(compression - 1.0)


def uncompress(spec: Tensor, compression: float) -> Tensor:
    """Inverse of `compress`, with a 1e-30 power floor (a normal float32)."""
    if compression == 1.0:
        return spec
    power = spec.square().sum(dim=-1, keepdim=True)
    mag = power.clamp_min(1e-30).sqrt()
    return spec * mag.pow(1.0 / compression - 1.0)


def compressed_stft(x: Tensor, cfg: STFTConfig, compression: float,
                    discard_last_freq_bin: bool = False,
                    eps: float = 1.0e-5) -> Tensor:
    """STFT -> optional last-bin drop -> magnitude compression."""
    spec = stft(x, cfg)
    if discard_last_freq_bin:
        spec = spec[:, :-1]
    return compress(spec, compression, eps)


def compressed_istft(spec: Tensor, cfg: STFTConfig, compression: float,
                     discard_last_freq_bin: bool = False,
                     length: tp.Optional[int] = None) -> Tensor:
    """Uncompress -> re-append the last bin (zeros) -> iSTFT."""
    spec = uncompress(spec, compression)
    if discard_last_freq_bin:
        spec = torch.cat([spec, torch.zeros_like(spec[:, :1])], dim=1)
    return istft(spec, cfg, length=length)


# ---------------------------------------------------------------------------
# Streaming (one hop per step)
# ---------------------------------------------------------------------------

def init_stft_carry(cfg: STFTConfig, batch: int, dtype: torch.dtype,
                    device: torch.device) -> Tensor:
    """Rolling input cache [B, n_fft - hop]."""
    return torch.zeros(batch, cfg.cache_len, dtype=dtype, device=device)


def init_istft_carry(cfg: STFTConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Tensor:
    """Rolling overlap-add cache [B, n_fft - hop]."""
    return torch.zeros(batch, cfg.cache_len, dtype=dtype, device=device)


def stft_streaming_step(x: Tensor, carry: Tensor,
                        cfg: STFTConfig) -> tp.Tuple[Tensor, Tensor]:
    """One analysis hop. x: [B, hop], carry: [B, n_fft-hop] ->
    (spec [B, n_freq, 2], new_carry): the center=False STFT of the signal
    with the carry prepended. The frame is float32; the spec is cast back to
    the input dtype."""
    in_dtype = x.dtype
    frame = torch.cat([carry, x], dim=1).float()  # [B, n_fft]
    new_carry = frame[:, -cfg.cache_len:].to(in_dtype)
    re, im = _dft(frame, cfg)
    return torch.stack([re, im], dim=-1).to(in_dtype), new_carry


def istft_streaming_step(spec: Tensor, carry: Tensor,
                         cfg: STFTConfig) -> tp.Tuple[Tensor, Tensor]:
    """One synthesis hop. spec: [B, n_freq, 2], carry: [B, n_fft-hop] ->
    (wav [B, hop], new_carry), with the steady-state synthesis window; the
    output is delayed n_fft - hop samples relative to the input."""
    in_dtype = spec.dtype
    spec = spec.float()
    frame = _idft(spec[..., 0], spec[..., 1], cfg)
    frame = frame * cfg.tensor("synthesis_window", frame.device)
    head = frame[:, :cfg.cache_len] + carry.float()
    frame = torch.cat([head, frame[:, cfg.cache_len:]], dim=1)
    out = frame[:, :cfg.hop_size]
    new_carry = frame[:, -cfg.cache_len:]
    return out.to(in_dtype), new_carry.to(in_dtype)



def stream_stft(x: Tensor, cfg: STFTConfig) -> Tensor:
    """`stft_streaming_step` over a [B, hop*T] signal, hop by hop ->
    [B, n_freq, T, 2] (fastenhancer_tpu/functional/stft.py:492, which scans
    it). Mostly used by tests to hold streaming to offline(center=False)."""
    b, length = x.shape
    t = length // cfg.hop_size
    carry = init_stft_carry(cfg, b, x.dtype, x.device)
    specs = []
    for i in range(t):
        spec, carry = stft_streaming_step(
            x[:, i * cfg.hop_size:(i + 1) * cfg.hop_size], carry, cfg)
        specs.append(spec)
    return torch.stack(specs, dim=2)  # [B, n_freq, T, 2]


def stream_istft(spec: Tensor, cfg: STFTConfig) -> Tensor:
    """`istft_streaming_step` over [B, n_freq, T, 2], frame by frame ->
    [B, hop*T] (fastenhancer_tpu/functional/stft.py:509)."""
    b = spec.shape[0]
    carry = init_istft_carry(cfg, b, spec.dtype, spec.device)
    outs = []
    for i in range(spec.shape[2]):
        out, carry = istft_streaming_step(spec[:, :, i], carry, cfg)
        outs.append(out)
    return torch.cat(outs, dim=1)

# ---------------------------------------------------------------------------
# Streaming (C hops per step)
# ---------------------------------------------------------------------------

def stft_streaming_chunk(x: Tensor, carry: Tensor,
                         cfg: STFTConfig) -> tp.Tuple[Tensor, Tensor]:
    """C analysis hops. x: [B, hop*C], carry: [B, n_fft-hop] ->
    (spec [B, n_freq, C, 2], new_carry): the same frames as C single-hop
    steps, with the DFT as one batched product (or FFT) over all C."""
    buf = torch.cat([carry, x], dim=1)
    new_carry = buf[:, -cfg.cache_len:]
    frames = frame_signal(buf.float(), cfg.n_fft, cfg.hop_size)  # [B, C, n]
    re, im = _dft(frames, cfg)
    out = torch.stack([re, im], dim=-1).transpose(1, 2)  # [B, n_freq, C, 2]
    return out.to(x.dtype), new_carry


def istft_streaming_chunk(spec: Tensor, carry: Tensor,
                          cfg: STFTConfig) -> tp.Tuple[Tensor, Tensor]:
    """C synthesis hops. spec: [B, n_freq, C, 2], carry: [B, n_fft-hop] ->
    (wav [B, hop*C], new_carry): the C frames overlap-added at once, the
    carry added to the first cache_len samples; the same output as C
    single-hop steps."""
    c = spec.shape[2]
    specf = spec.float()
    re = specf[..., 0].transpose(1, 2)  # [B, C, n_freq]
    im = specf[..., 1].transpose(1, 2)
    frames = _idft(re, im, cfg)  # [B, C, n_fft]
    frames = frames * cfg.tensor("synthesis_window", frames.device)
    y = overlap_add(frames, cfg.hop_size)  # [B, (C-1)*hop + n_fft]
    y = torch.cat([y[:, :cfg.cache_len] + carry.float(),
                   y[:, cfg.cache_len:]], dim=1)
    out = y[:, :c * cfg.hop_size]
    new_carry = y[:, c * cfg.hop_size:]
    return out.to(spec.dtype), new_carry.to(spec.dtype)
