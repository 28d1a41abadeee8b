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
* `gru_scan` is the wrapper, the counterpart of `gru_scan_pallas`: it
  checks the operands and calls the op `torch.ops.fastenhancer.gru_scan`
  (ops/_library.py), whose CPU implementation is the plain version
  (`cpu_impl`, differentiable through `autograd_cpu_impl`) and whose CUDA one
  launches the kernel or raises (`cuda_impl`); nothing falls back. The
  kernel has no backward, as the Pallas kernel has no VJP, so a CUDA
  input that requires a gradient raises. `gru_scan.launches` counts
  kernel launches, in `cuda_impl`. The kernel has two forms,
  chosen by `kernel_form` from the shape and type: "tc" (bfloat16 on the
  tensor cores, a thread block of `tc_warps(H)` warps per tile of 16
  rows; `gru_scan.tc_launches` counts it) and "scalar" (float32 and odd
  H; the correctness reference). `launch_scalar` and `launch_tc` launch
  one form directly and count nothing.
* `gru_fused(params, x, h0)` is the drop-in for nn.gru (the counterpart of
  `gru_pallas`), weight-norm parameters included; `bigru_fused(params, x)`
  the drop-in for nn.bigru, one launch a direction.

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
# x_proj, h0, w_hh, b_hh, ys, h_T; T, N, H; the stream (the tensor-core form)
_TC_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# rows of a tile of the tensor-core form (csrc/gru_scan_tc.cuh)
TC_ROWS = 16


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


def tc_tiles(n: int) -> int:
    """Tiles of 16 rows, a thread block each, of the tensor-core form."""
    return -(-n // TC_ROWS)


def tc_warps(hidden: int) -> int:
    """Warps of a tile in the tensor-core form: one per unit group of 8 (U =
    ceil(H / 8)) up to H = 64, one per two groups above (3 at H = 20, 5 at
    H = 36, 8 at H = 64 and 128)."""
    units = -(-hidden // 8)
    return units if units <= 8 else -(-units // 2)


def tc_smem_bytes(hidden: int) -> int:
    """Shared memory of one thread block of the tensor-core form, as
    gru_scan_tc.cuh's GruTcGeom counts it: the double-buffered hi/lo h
    tile [2, 2, 16, ld] bf16, and W_hh's fragments where they are not in
    registers (H > 64)."""
    units, ksteps = -(-hidden // 8), -(-hidden // 16)
    hbuf = 4 * TC_ROWS * _build.ld_of(16 * ksteps) * 2
    return hbuf + (0 if hidden <= 64 else 3 * units * ksteps * 32 * 8)


def kernel_form(n: int, hidden: int, dtype: torch.dtype) -> str:
    """Which form of the kernel runs, by shape alone, before launch: "tc"
    (tensor cores, csrc/gru_scan_tc.cuh) for bfloat16 at every even H <=
    MAX_HIDDEN (any N >= 1; its shared memory fits at H = 128; it reads
    and writes bf16 pairs); else "scalar" (float32, odd H)."""
    if (dtype == torch.bfloat16 and n >= 1 and 2 <= hidden <= MAX_HIDDEN
            and hidden % 2 == 0
            and tc_smem_bytes(hidden) <= _build.MAX_SMEM_BYTES):
        return "tc"
    return "scalar"


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


def _cuda_operands(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor
                   ) -> tp.Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Checks of a launch on CUDA tensors that passed _check; returns them
    contiguous."""
    if x_proj.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not "
                         f"{x_proj.device}")
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x_proj, h0, w_hh, b_hh)):
        raise RuntimeError("gru_scan's kernel has no backward: run it under "
                           "torch.no_grad(), or use nn.gru to train")
    hidden = x_proj.shape[-1] // 3
    if hidden > MAX_HIDDEN:
        raise ValueError(f"H={hidden}: the kernel takes H <= {MAX_HIDDEN}")
    if x_proj.shape[1] == 0:
        raise ValueError("need N >= 1")
    for name, a in (("h0", h0), ("w_hh", w_hh), ("b_hh", b_hh)):
        if a.dtype != x_proj.dtype:
            raise ValueError(f"{name} is {a.dtype}; every operand must be "
                             f"{x_proj.dtype}")
    return (x_proj.contiguous(), h0.contiguous(), w_hh.contiguous(),
            b_hh.contiguous())


def _launch(fn: tp.Callable[..., int], x_proj: Tensor, h0: Tensor,
            w_hh: Tensor, b_hh: Tensor, *per_block: int
            ) -> tp.Tuple[Tensor, Tensor]:
    t, n, h3 = x_proj.shape
    ys = torch.empty(t, n, h3 // 3, dtype=x_proj.dtype, device=x_proj.device)
    h_t = torch.empty_like(h0)
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        err = fn(x_proj.data_ptr(), h0.data_ptr(), w_hh.data_ptr(),
                 b_hh.data_ptr(), ys.data_ptr(), h_t.data_ptr(), t, n,
                 h3 // 3, *per_block, stream)
    _build.check_launch("gru_scan", err)
    return ys, h_t


def launch_scalar(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor
                  ) -> tp.Tuple[Tensor, Tensor]:
    """Launch the scalar form (a thread per (row, unit) pair) on CUDA
    tensors that passed _check, float32 or bfloat16; counts nothing."""
    x_proj, h0, w_hh, b_hh = _cuda_operands(x_proj, h0, w_hh, b_hh)
    fn = _build.entry("gru_scan", x_proj.dtype, _ARGTYPES)
    tile = rows_per_block(x_proj.shape[1], x_proj.shape[-1] // 3)
    return _launch(fn, x_proj, h0, w_hh, b_hh, tile)


def launch_tc(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor
              ) -> tp.Tuple[Tensor, Tensor]:
    """Launch the tensor-core form (tc_warps(H) warps a tile of 16 rows) on
    bfloat16 CUDA tensors that passed _check and whose shape kernel_form
    gives to it; counts nothing."""
    n, hidden = x_proj.shape[1], x_proj.shape[-1] // 3
    if kernel_form(n, hidden, x_proj.dtype) != "tc":
        raise ValueError(f"the tensor-core form does not take N={n}, "
                         f"H={hidden} in {x_proj.dtype} (see kernel_form)")
    x_proj, h0, w_hh, b_hh = _cuda_operands(x_proj, h0, w_hh, b_hh)
    if x_proj.data_ptr() % 4:
        x_proj = x_proj.clone()  # the kernel reads 4-byte bf16 pairs
    fn = _build.function("gru_scan", "gru_scan_tc_bf16", ctypes.c_int,
                         _TC_ARGTYPES)
    return _launch(fn, x_proj, h0, w_hh, b_hh)


def gru_scan(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor
             ) -> tp.Tuple[Tensor, Tensor]:
    """The GRU recurrence over T steps as one kernel launch.

    x_proj [T, N, 3H], h0 [N, H], w_hh [3H, H], b_hh [3H], all of x_proj's
    dtype (float32 or bfloat16) and device -> (ys [T, N, H], h_T [N, H]),
    fresh tensors. The op `torch.ops.fastenhancer.gru_scan`
    (ops/_library.py): on the CPU the plain version, differentiable; on a
    CUDA device it launches the form `kernel_form` picks (building the
    kernel on first use) and raises if it cannot, or if an input requires
    a gradient (the kernel has no backward)."""
    _check(x_proj, h0, w_hh, b_hh)
    _build.check_device(x_proj)
    if (x_proj.device.type == "cuda" and torch.is_grad_enabled()
            and any(a.requires_grad for a in (x_proj, h0, w_hh, b_hh))):
        raise RuntimeError("gru_scan's kernel has no backward: run it under "
                           "torch.no_grad(), or use nn.gru to train")
    return tuple(torch.ops.fastenhancer.gru_scan(x_proj, h0, w_hh, b_hh))


def cpu_impl(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor
             ) -> tp.Tuple[Tensor, Tensor]:
    """The op's CPU implementation: the plain version."""
    return gru_scan_reference(x_proj, h0, w_hh, b_hh)


def fake_impl(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor
              ) -> tp.Tuple[Tensor, Tensor]:
    """The op's shapes and types: ys [T, N, H] and h_T like h0, in
    x_proj's dtype."""
    t, n, h3 = x_proj.shape
    return x_proj.new_empty(t, n, h3 // 3), x_proj.new_empty(n, h3 // 3)


def cuda_impl(x_proj: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor
              ) -> tp.Tuple[Tensor, Tensor]:
    """The op's CUDA implementation: one launch of the form kernel_form
    picks, counted in gru_scan.launches (and .tc_launches)."""
    n, hidden = x_proj.shape[1], x_proj.shape[-1] // 3
    if kernel_form(n, hidden, x_proj.dtype) == "tc":
        out = launch_tc(x_proj, h0, w_hh, b_hh)
        gru_scan.tc_launches += 1
    else:
        out = launch_scalar(x_proj, h0, w_hh, b_hh)
    gru_scan.launches += 1
    return out


class _PlainGradient(torch.autograd.Function):
    """The op on the CPU with a gradient: the plain version run again with
    autograd in backward, then differentiated. The kernel has no backward,
    as the Pallas kernel has no VJP."""

    @staticmethod
    def forward(ctx, x_proj, h0, w_hh, b_hh):
        ctx.save_for_backward(x_proj, h0, w_hh, b_hh)
        with torch._C._AutoDispatchBelowAutograd():
            return torch.ops.fastenhancer.gru_scan(x_proj, h0, w_hh, b_hh)

    @staticmethod
    def backward(ctx, g_ys, g_h):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = gru_scan_reference(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, wanted, (g_ys, g_h),
                                         allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves)


def autograd_cpu_impl(x_proj: Tensor, h0: Tensor, w_hh: Tensor,
                      b_hh: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """The op's autograd kernel on the CPU only (so that a CUDA call pays
    no Python autograd layer): _PlainGradient where an input requires a
    gradient, else the CPU implementation."""
    args = (x_proj, h0, w_hh, b_hh)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _PlainGradient.apply(*args)
    with torch._C._AutoDispatchBelowAutograd():
        return torch.ops.fastenhancer.gru_scan(*args)


gru_scan.launches = 0
gru_scan.tc_launches = 0


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


def bigru_fused(params: Params, x: Tensor) -> Tensor:
    """Drop-in for nn.bigru with each direction one gru_scan launch: the
    backward one over the time-flipped input, its outputs flipped back.
    x: [T, N, I] -> [T, N, 2H] in nn.bigru's [forward, backward] layout."""
    y_fwd, _ = gru_fused(params["fwd"], x)
    y_bwd, _ = gru_fused(params["bwd"], x.flip(0))
    return torch.cat([y_fwd, y_bwd.flip(0)], dim=-1)
