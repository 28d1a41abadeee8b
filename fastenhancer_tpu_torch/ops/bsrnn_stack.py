"""BSRNN's LSTM layer stack for one streaming frame: plan, plain version and
the wrapper of the hand-written CUDA kernel (csrc/bsrnn_stack.cu).

Replaces fastenhancer_tpu/ops/bsrnn_stack.py::bsrnn_stack_step (the Pallas
TPU kernel) for the folded layer form (pre-norm BNs fused into the LSTM
input weights). Per layer: one time-LSTM step on every (band, stream) row
with its (h, c) carry, fc_time plus residual, a bidirectional LSTM sweep
across the bands (both directions in one loop), fc_freq plus residual.

Rows are frequency-major, as in the Pallas kernel: x is [F, B, C] and the
carries are [L, 2 (h, c), F, B, H], so the batch axis is one axis the
serving engine can infer.

* `plan_band_stack` packs folded layer params into stacked, pre-transposed
  arrays with the Pallas plan's keys and shapes.
* `bsrnn_stack_reference` is the plain PyTorch version of the kernel's
  math, with the Pallas kernel's cast points: float32 accumulation and gate
  math; h and c rounded to the activation type where they are stored; each
  fc output rounded before its residual and each residual sum rounded; the
  sweep's input projection (with b_ih + b_hh summed in the activation type)
  rounded before the recurrent half is added; the sweep's h rounded for
  its product and its output, its c kept in float32. The CPU path uses it;
  the card's checks compare the kernel against it.
* `bsrnn_stack_step` is the wrapper: a CPU tensor goes to the plain
  version, a CUDA tensor launches the kernel or raises; nothing falls back.
  `bsrnn_stack_step.launches` counts kernel launches.

What bounds the kernel on the H100, and what its design does about it, is
in the note at the top of csrc/bsrnn_stack.cu.
"""
from __future__ import annotations

import ctypes
import typing as tp

import torch

from . import _build

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

PLAN_KEYS = ("w_tih", "w_thh", "b_t", "w_fct", "b_fct",
             "w_fih", "b_fih", "w_fhh", "b_fhh", "w_fcf", "b_fcf")
MAX_SMEM_BYTES = _build.MAX_SMEM_BYTES
# x, h, x_out, h_out, the plan; B, F, C, H, L; the stream
_ARGTYPES = ([ctypes.c_void_p] * (4 + len(PLAN_KEYS)) + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


# ---------------------------------------------------------------------------
# Plan: folded layer params -> stacked kernel-ready arrays
# ---------------------------------------------------------------------------

def plan_band_stack(layers: tp.Sequence[Params],
                    dtype: tp.Optional[torch.dtype] = None) -> Params:
    """Pack folded BSRNN layer params (Model.fold() output: norm_time and
    norm_freq already fused into the LSTM input weights) into stacked,
    pre-transposed arrays with the layer index leading; matrices are
    [in, out], gates in torch order (i, f, g, o). dtype=None keeps the
    layers' own dtype. b_t is b_ih + b_hh of the time LSTM, summed before
    the cast; the sweep's b_fih and b_fhh stay apart, as in the Pallas
    plan."""
    l0 = layers[0]["rnn_time"]
    dtype = l0["weight_hh"].dtype if dtype is None else dtype
    c = l0["weight_ih"].shape[1]

    def bias(p: Params) -> Tensor:
        return p["bias"] if "bias" in p else p["weight"].new_zeros(c)

    def both(p: Params, fn: tp.Callable[[Params], Tensor]) -> Tensor:
        return torch.stack([fn(p["rnn_freq"][d]) for d in ("fwd", "bwd")])

    def one(p: Params) -> Params:
        rt = p["rnn_time"]
        return {
            "w_tih": rt["weight_ih"].T,
            "w_thh": rt["weight_hh"].T,
            "b_t": (rt["bias_ih"] + rt["bias_hh"])[None],
            "w_fct": p["fc_time"]["weight"].T,
            "b_fct": bias(p["fc_time"])[None],
            "w_fih": both(p, lambda r: r["weight_ih"].T),
            "b_fih": both(p, lambda r: r["bias_ih"][None]),
            "w_fhh": both(p, lambda r: r["weight_hh"].T),
            "b_fhh": both(p, lambda r: r["bias_hh"][None]),
            "w_fcf": p["fc_freq"]["weight"].T,
            "b_fcf": bias(p["fc_freq"])[None],
        }

    per_layer = [one(p) for p in layers]
    return {k: torch.stack([p[k] for p in per_layer]).to(dtype).contiguous()
            for k in PLAN_KEYS}


def plan_shapes(num_layers: int, channels: int, hidden: int
                ) -> tp.Dict[str, tp.Tuple[int, ...]]:
    """Shape of each plan array, as `plan_band_stack` makes it and the
    kernel reads it."""
    nl, c, hd = num_layers, channels, hidden
    return {"w_tih": (nl, c, 4 * hd), "w_thh": (nl, hd, 4 * hd),
            "b_t": (nl, 1, 4 * hd), "w_fct": (nl, hd, c), "b_fct": (nl, 1, c),
            "w_fih": (nl, 2, c, 4 * hd), "b_fih": (nl, 2, 1, 4 * hd),
            "w_fhh": (nl, 2, hd, 4 * hd), "b_fhh": (nl, 2, 1, 4 * hd),
            "w_fcf": (nl, 2 * hd, c), "b_fcf": (nl, 1, c)}


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel's math
# ---------------------------------------------------------------------------

def _lstm_gates(gates: Tensor, c: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """gates: float32 [..., 4H] in torch (i, f, g, o) order -> (h', c')."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def bsrnn_stack_reference(plan: Params, x: Tensor, h: Tensor
                          ) -> tp.Tuple[Tensor, Tensor]:
    """x: [F, B, C], h: [L, 2, F, B, H] -> (x_out [F, B, C], h_new like h).

    float32 accumulation and gate math; results rounded to x.dtype where
    the kernel rounds them (see the module docstring)."""
    fb, b, c = x.shape
    nl, hd = h.shape[0], h.shape[-1]
    dt = x.dtype
    rows = fb * b
    p = {k: v.float() for k, v in plan.items()}
    xs = x.reshape(rows, c)
    h_new = torch.empty_like(h)
    for i in range(nl):
        # --- time-LSTM cell, fc_time + residual ---
        gates = (xs.float() @ p["w_tih"][i]
                 + h[i, 0].reshape(rows, hd).float() @ p["w_thh"][i]
                 + p["b_t"][i])
        ht, ct = _lstm_gates(gates, h[i, 1].reshape(rows, hd).float())
        ht = ht.to(dt)
        h_new[i, 0] = ht.reshape(fb, b, hd)
        h_new[i, 1] = ct.to(dt).reshape(fb, b, hd)
        xs = (ht.float() @ p["w_fct"][i] + p["b_fct"][i]).to(dt) + xs
        # --- bidirectional sweep over the bands, both directions at once ---
        bias = (plan["b_fih"][i] + plan["b_fhh"][i]).float()    # [2, 1, 4H]
        xp = (torch.matmul(xs.float(), p["w_fih"][i]) + bias).to(dt)
        xp = xp.reshape(2, fb, b, 4 * hd)
        hs = xs.new_zeros(2, b, hd, dtype=torch.float32)
        cs = torch.zeros_like(hs)
        ys = torch.empty(fb, b, 2 * hd, dtype=dt, device=x.device)
        for f in range(fb):
            xin = torch.stack([xp[0, f], xp[1, fb - 1 - f]]).float()
            gates = xin + torch.bmm(hs.to(dt).float(), p["w_fhh"][i])
            hs, cs = _lstm_gates(gates, cs)
            ys[f, :, :hd] = hs[0].to(dt)
            ys[fb - 1 - f, :, hd:] = hs[1].to(dt)
        xs = (ys.reshape(rows, 2 * hd).float() @ p["w_fcf"][i]
              + p["b_fcf"][i]).to(dt) + xs
    return xs.reshape(fb, b, c), h_new


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def smem_bytes(bands: int, channels: int, hidden: int) -> int:
    """Shared memory of one thread block (one stream): float32 activations
    [F, C], the sweep output [F, 2H] (which holds the time cell's input and
    output carries before the sweep), the sweep's double-buffered h and its
    c [3, 2, H]."""
    f, c, hd = bands, channels, hidden
    return 4 * (f * c + f * 2 * hd + 3 * 2 * hd)


def _check(plan: Params, x: Tensor, h: Tensor) -> None:
    if x.ndim != 3 or h.ndim != 5:
        raise ValueError(f"x must be [F, B, C] and h [L, 2, F, B, H]; got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    fb, b, c = x.shape
    nl, hd = h.shape[0], h.shape[-1]
    if b == 0:
        raise ValueError("need B >= 1")
    if tuple(h.shape) != (nl, 2, fb, b, hd):
        raise ValueError(f"h has shape {tuple(h.shape)}, expected "
                         f"{(nl, 2, fb, b, hd)}")
    shapes = plan_shapes(nl, c, hd)
    for name, t in (("x", x), ("h", h), *((k, plan[k]) for k in PLAN_KEYS)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every "
                             f"operand must be {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"plan[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")


def bsrnn_stack_step(plan: Params, x: Tensor, h: Tensor
                     ) -> tp.Tuple[Tensor, Tensor]:
    """One streaming frame through every layer.

    x: [F, B, C] frame activations (band-split output, frequency-major);
    h: [L, 2, F, B, H] stacked time-LSTM (h, c) carries -> (x_out [F, B, C],
    h_new like h), fresh tensors. Every operand has x's dtype (float32 or
    bfloat16) and device and is contiguous. On the CPU this is the plain
    version; on a CUDA device it launches the kernel (building it on first
    use), one thread block per stream, and raises if it cannot."""
    _check(plan, x, h)
    if x.device.type == "cpu":
        return bsrnn_stack_reference(plan, x, h)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    fn = _build.entry("bsrnn_stack", x.dtype, _ARGTYPES)
    fb, b, c = x.shape
    nl, hd = h.shape[0], h.shape[-1]
    smem = smem_bytes(fb, c, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"F={fb}, C={c}, H={hd} needs {smem} bytes of shared memory per "
            f"stream; the kernel has {MAX_SMEM_BYTES}")
    x_out = torch.empty_like(x)
    h_out = torch.empty_like(h)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), x_out.data_ptr(),
                 h_out.data_ptr(), *(plan[k].data_ptr() for k in PLAN_KEYS),
                 b, fb, c, hd, nl, stream)
    _build.check_launch("bsrnn_stack", err)
    bsrnn_stack_step.launches += 1
    return x_out, h_out


bsrnn_stack_step.launches = 0
