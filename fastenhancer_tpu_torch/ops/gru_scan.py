"""The GRU recurrence over a whole sequence: the plain version and the
wrapper of the hand-written CUDA kernel (csrc/gru_scan.cu).

Counterpart of fastenhancer_tpu/ops/gru_scan.py. The contract is nn.gru's
recurrent half (torch gate order r, z, n):

    gru_scan(x_proj [T, N, 3H], h0 [N, H], w_hh [3H, H], b_hh [3H])
        -> (ys [T, N, H], h_T [N, H])

where x_proj = x W_ih^T + b_ih comes from one matmul over the sequence.

* `gru_scan_reference` is the plain PyTorch version with the Pallas
  kernel's cast points: the state stays float32 across all T steps, w_hh
  and b_hh are read in float32, and only ys and h_T are rounded to the
  activation type. (nn.gru rounds h every step in bfloat16; this does not.)
* `gru_scan` is the wrapper, the counterpart of `gru_scan_pallas`: a CPU
  tensor goes to the plain version, a CUDA tensor launches the kernel or
  raises; nothing falls back. The kernel has no backward, as the Pallas
  kernel has no VJP, so a CUDA input that requires a gradient raises.
  `gru_scan.launches` counts kernel launches.
* `gru_fused(params, x, h0)` is the drop-in for nn.gru (the counterpart of
  `gru_pallas`), weight-norm parameters included.

What bounds the kernel on the H100, and what its design does about it, is
in the note at the top of csrc/gru_scan.cu.
"""
from __future__ import annotations

import ctypes
import typing as tp

import torch

from ..nn.layers import maybe_wn_weight
from . import _build

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

# the kernel's largest hidden width: w_hh in float32 fills 192 KB of the
# 227 KB of shared memory at H=128 (the port's recipes have H 18 to 128)
MAX_HIDDEN = 128
_THREADS = 256  # a thread per (row, unit) pair, at most this many per block
_SMS = 132      # the H100 SXM's streaming multiprocessors
# x_proj, h0, w_hh, b_hh, ys, h_T; T, N, H, rows per block; the stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def gru_scan_reference(x_proj: Tensor, h0: Tensor, w_hh: Tensor,
                       b_hh: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Plain version of the kernel: x_proj [T, N, 3H], h0 [N, H], w_hh
    [3H, H], b_hh [3H] -> (ys [T, N, H], h_T [N, H]) in x_proj's dtype,
    with a float32 state (see the module docstring). Differentiable."""
    dt = x_proj.dtype
    w = w_hh.float().T
    b = b_hh.float()
    h = h0.float()
    ys = []
    for xg in x_proj.float().unbind(0):
        xr, xz, xn = xg.chunk(3, dim=-1)
        hr, hz, hn = (h @ w + b).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        h = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
        ys.append(h)
    if not ys:
        return x_proj.new_zeros(0, *h0.shape), h.to(dt)
    return torch.stack(ys).to(dt), h.to(dt)


def rows_per_block(n: int, hidden: int) -> int:
    """Rows of one thread block: a thread per (row, unit), at most 256
    threads, and about one block per SM when N allows it."""
    return max(1, min(_THREADS // hidden, -(-n // _SMS)))


def _check(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor) -> None:
    if x_proj.ndim != 3 or x_proj.shape[-1] % 3:
        raise ValueError("x_proj must be [T, N, 3H]; got "
                         f"{tuple(x_proj.shape)}")
    t, n, h3 = x_proj.shape
    h = h3 // 3
    want = {"h0": (n, h), "w_hh": (h3, h), "b_hh": (h3,)}
    for name, a in (("h0", h0), ("w_hh", w_hh), ("b_hh", b_hh)):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{want[name]}")
        if a.device != x_proj.device:
            raise ValueError(f"{name} is on {a.device}, x_proj on "
                             f"{x_proj.device}")


def gru_scan(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor
             ) -> tp.Tuple[Tensor, Tensor]:
    """The GRU recurrence over T steps as one kernel launch.

    x_proj [T, N, 3H], h0 [N, H], w_hh [3H, H], b_hh [3H], all of x_proj's
    dtype (float32 or bfloat16) and device -> (ys [T, N, H], h_T [N, H]),
    fresh tensors. On the CPU this is the plain version; on a CUDA device
    it launches the kernel (building it on first use), a thread block per
    tile of rows, and raises if it cannot, or if an input requires a
    gradient (the kernel has no backward)."""
    _check(x_proj, h0, w_hh, b_hh)
    if x_proj.device.type == "cpu":
        return gru_scan_reference(x_proj, h0, w_hh, b_hh)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x_proj, h0, w_hh, b_hh)):
        raise RuntimeError("gru_scan's kernel has no backward: run it under "
                           "torch.no_grad(), or use nn.gru to train")
    t, n, h3 = x_proj.shape
    hidden = h3 // 3
    if hidden > MAX_HIDDEN:
        raise ValueError(f"H={hidden}: the kernel takes H <= {MAX_HIDDEN}")
    if n == 0:
        raise ValueError("need N >= 1")
    for name, a in (("h0", h0), ("w_hh", w_hh), ("b_hh", b_hh)):
        if a.dtype != x_proj.dtype:
            raise ValueError(f"{name} is {a.dtype}; every operand must be "
                             f"{x_proj.dtype}")
    fn = _build.entry("gru_scan", x_proj.dtype, _ARGTYPES)
    x_proj, h0 = x_proj.contiguous(), h0.contiguous()
    w_hh, b_hh = w_hh.contiguous(), b_hh.contiguous()
    tile = rows_per_block(n, hidden)
    ys = torch.empty(t, n, hidden, dtype=x_proj.dtype, device=x_proj.device)
    h_t = torch.empty_like(h0)
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        err = fn(x_proj.data_ptr(), h0.data_ptr(), w_hh.data_ptr(),
                 b_hh.data_ptr(), ys.data_ptr(), h_t.data_ptr(), t, n, hidden,
                 tile, stream)
    _build.check_launch("gru_scan", err)
    gru_scan.launches += 1
    return ys, h_t


gru_scan.launches = 0


def gru_fused(params: Params, x: Tensor, h0: tp.Optional[Tensor] = None
              ) -> tp.Tuple[Tensor, Tensor]:
    """Drop-in for nn.gru with the recurrence as one gru_scan launch.
    x: [T, N, I] -> (y [T, N, H], h_T [N, H]); weight-norm {g, v} weights
    are resolved first."""
    w_ih = maybe_wn_weight(params, "weight_ih")
    w_hh = maybe_wn_weight(params, "weight_hh")
    if h0 is None:
        h0 = x.new_zeros(x.shape[1], w_hh.shape[1])
    x_proj = x @ w_ih.T + params["bias_ih"]
    return gru_scan(x_proj, h0, w_hh, params["bias_hh"])
