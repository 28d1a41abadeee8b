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
* `bsrnn_stack_step` is the wrapper: it checks the operands and calls the
  op `torch.ops.fastenhancer.bsrnn_stack` (ops/_library.py), whose CPU
  implementation is the plain version (`cpu_impl`) and whose CUDA one
  launches the kernel or raises (`cuda_impl`); nothing falls back.
  The kernel has two forms, chosen by `kernel_form` from the shapes and
  dtype before launch: bfloat16 with C and H multiples of 16, C <= 64 and
  H <= 128 (BSRNN-S and -XT) runs the tensor-core form (csrc/band_tc.cuh:
  a cluster of two thread blocks per tile of 8 streams, two workspaces
  from `tc_workspace`); float32 and every other shape run the
  scalar form (one thread block per stream). `bsrnn_stack_step.launches`
  counts launches of either form, `.tc_launches` the tensor-core form's,
  both in `cuda_impl`.
  `launch_scalar` and `launch_tc` launch one form directly and count
  nothing (for timing one against the other).

What bounds each form on the H100, and what its design does about it, is
in the notes at the top of csrc/bsrnn_stack.cu and csrc/band_tc.cuh.
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
# the tensor-core form adds the two workspaces
_TC_ARGTYPES = ([ctypes.c_void_p] * (6 + len(PLAN_KEYS))
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])


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

# the tensor-core form (csrc/band_tc.cuh): streams of a tile, units of a
# time-cell weight stage and slots of its ring, rows of an A tile held at
# once, the largest C and H it takes
TC_TILE = 8
TC_UNITS = 16
TC_SLOTS = 3
TC_CHUNK = 128
TC_MAX_CHANNELS = 64
TC_MAX_HIDDEN = 128


def smem_bytes(bands: int, channels: int, hidden: int) -> int:
    """Shared memory of one thread block (one stream) of the scalar form:
    float32 activations [F, C], the sweep output [F, 2H] (which holds the
    time cell's input and output carries before the sweep), the sweep's
    double-buffered h and its c [3, 2, H]."""
    f, c, hd = bands, channels, hidden
    return 4 * (f * c + f * 2 * hd + 3 * 2 * hd)


def tc_smem_bytes(bands: int, channels: int, hidden: int) -> int:
    """Shared memory of one thread block of the tensor-core form, as
    band_tc.cuh's BandGeom counts it: the zero chunk, the x tile, the h
    double buffer and the region the phases share (the largest of the time
    cell's h and c/h' rows and three-slot ring, W_hh, W_ih, and fc_freq's
    ys rows and weight)."""
    f, c, hd, s = bands, channels, hidden, TC_TILE
    ldx, ldh, ldg = _build.ld_of(c), _build.ld_of(hd), _build.ld_of(4 * hd)
    stage = max((c + hd) * _build.ld_of(4 * TC_UNITS), hd * ldx)
    region = max(2 * TC_CHUNK * ldh + TC_SLOTS * stage, hd * ldg, c * ldg,
                 TC_CHUNK * _build.ld_of(2 * hd) + 2 * hd * ldx)
    return 2 * (8 + f * s * ldx + 2 * s * ldh + region)


def kernel_form(bands: int, channels: int, hidden: int,
                dtype: torch.dtype) -> str:
    """Which form of the kernel runs, by shape alone, before launch: "tc"
    (tensor cores, csrc/band_tc.cuh) for bfloat16 when C and H are
    multiples of 16, C <= 64, H <= 128 and its shared memory fits; else
    "scalar" (csrc/bsrnn_stack.cu's float32-FMA form, which float32 always
    takes)."""
    if (dtype == torch.bfloat16 and channels % 16 == 0 and hidden % 16 == 0
            and channels <= TC_MAX_CHANNELS and hidden <= TC_MAX_HIDDEN
            and tc_smem_bytes(bands, channels, hidden) <= MAX_SMEM_BYTES):
        return "tc"
    return "scalar"


def tc_workspace_shapes(batch: int, bands: int, hidden: int
                        ) -> tp.Tuple[tp.Tuple[int, ...], tp.Tuple[int, ...]]:
    """Shapes of the tensor-core form's two bfloat16 workspaces, per tile of
    8 streams: xp, the sweep's input projection in the recurrence's
    fragment order [tiles, 2, F, H/16, 32 lanes, 16], and ys, the sweep's
    output [tiles, F * 8, 2H]."""
    tiles = -(-batch // TC_TILE)
    return ((tiles, 2, bands, hidden // 16, 32, 2 * TC_TILE),
            (tiles, bands * TC_TILE, 2 * hidden))


def tc_workspace(batch: int, bands: int, hidden: int,
                 device: torch.device) -> tp.Tuple[Tensor, Tensor]:
    """The two workspaces of tc_workspace_shapes, uninitialised."""
    return tuple(torch.empty(s, dtype=torch.bfloat16, device=device)
                 for s in tc_workspace_shapes(batch, bands, hidden))


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


def _check_tc(plan: Params, x: Tensor, h: Tensor, xp_ws: Tensor,
              ys_ws: Tensor) -> None:
    """What the tensor-core form takes beyond _check: its shapes,
    workspaces of tc_workspace_shapes on x's device, and 16-byte aligned
    operands (its copies move 16 bytes a chunk)."""
    fb, b, c = x.shape
    hd = h.shape[-1]
    if kernel_form(fb, c, hd, x.dtype) != "tc":
        raise ValueError(f"the tensor-core form does not take F={fb}, C={c}, "
                         f"H={hd} in {x.dtype} (see kernel_form)")
    want = tc_workspace_shapes(b, fb, hd)
    for name, t, shape in (("xp_ws", xp_ws, want[0]),
                           ("ys_ws", ys_ws, want[1])):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous bfloat16 {shape} "
                             f"on {x.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("x", x), ("h", h), ("xp_ws", xp_ws), ("ys_ws", ys_ws),
                    *((k, plan[k]) for k in PLAN_KEYS)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             f"tensor-core form")


def _cuda_only(x: Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {x.device}")


def launch_scalar(plan: Params, x: Tensor, h: Tensor
                  ) -> tp.Tuple[Tensor, Tensor]:
    """Launch the scalar form (one thread block per stream) on CUDA tensors
    that passed _check; counts nothing."""
    _cuda_only(x)
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
    return x_out, h_out


def launch_tc(plan: Params, x: Tensor, h: Tensor, xp_ws: Tensor,
              ys_ws: Tensor) -> tp.Tuple[Tensor, Tensor]:
    """Launch the tensor-core form on bfloat16 CUDA tensors that passed
    _check, with its workspaces (tc_workspace). Counts nothing."""
    _check_tc(plan, x, h, xp_ws, ys_ws)
    _cuda_only(x)
    fn = _build.function("bsrnn_stack", "bsrnn_stack_tc_bf16", ctypes.c_int,
                         _TC_ARGTYPES)
    fb, b, c = x.shape
    nl, hd = h.shape[0], h.shape[-1]
    x_out = torch.empty_like(x)
    h_out = torch.empty_like(h)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), x_out.data_ptr(),
                 h_out.data_ptr(), *(plan[k].data_ptr() for k in PLAN_KEYS),
                 xp_ws.data_ptr(), ys_ws.data_ptr(), b, fb, c, hd, nl,
                 stream)
    _build.check_launch("bsrnn_stack", err)
    return x_out, h_out


def bsrnn_stack_step(plan: Params, x: Tensor, h: Tensor
                     ) -> tp.Tuple[Tensor, Tensor]:
    """One streaming frame through every layer.

    x: [F, B, C] frame activations (band-split output, frequency-major);
    h: [L, 2, F, B, H] stacked time-LSTM (h, c) carries -> (x_out [F, B, C],
    h_new like h), fresh tensors. Every operand has x's dtype (float32 or
    bfloat16) and device and is contiguous. The op `torch.ops.fastenhancer.
    bsrnn_stack` (ops/_library.py): on the CPU the plain version; on a CUDA
    device it launches the form `kernel_form` picks (building the kernel on
    first use) and raises if it cannot. `bsrnn_stack_step.launches` counts
    launches of either form, `.tc_launches` those of the tensor-core
    form."""
    _check(plan, x, h)
    _build.check_device(x)
    return tuple(torch.ops.fastenhancer.bsrnn_stack(
        [plan[k] for k in PLAN_KEYS], x, h))


def cpu_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor
             ) -> tp.Tuple[Tensor, Tensor]:
    """The op's CPU implementation: the plain version."""
    return bsrnn_stack_reference(dict(zip(PLAN_KEYS, plan)), x, h)


def fake_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor
              ) -> tp.Tuple[Tensor, Tensor]:
    """The op's shapes and types: x_out like x, h_new like h."""
    return torch.empty_like(x), torch.empty_like(h)


def cuda_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor
              ) -> tp.Tuple[Tensor, Tensor]:
    """The op's CUDA implementation: one launch of the form kernel_form
    picks, counted in bsrnn_stack_step.launches (and .tc_launches)."""
    plan = dict(zip(PLAN_KEYS, plan))
    fb, b, c = x.shape
    hd = h.shape[-1]
    if kernel_form(fb, c, hd, x.dtype) == "tc":
        out = launch_tc(plan, x, h, *tc_workspace(b, fb, hd, x.device))
        bsrnn_stack_step.tc_launches += 1
    else:
        out = launch_scalar(plan, x, h)
    bsrnn_stack_step.launches += 1
    return out


bsrnn_stack_step.launches = 0
bsrnn_stack_step.tc_launches = 0
