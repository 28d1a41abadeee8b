"""The dprnn block stack for one streaming frame: plan, plain version and the
wrapper of the hand-written CUDA kernel (csrc/dprnn_stack.cu).

Replaces fastenhancer_tpu/ops/dprnn_stack.py::dprnn_stack_step (the Pallas
TPU kernel) for the folded block form (post-BNs merged into the fcs,
pre-norms into the GRU input weights). Per block: one time-GRU step on
every (bin, stream) row with its carry, trnn_fc plus residual, a
bidirectional GRU sweep across the F' bins (both directions in one loop),
frnn_fc plus residual.

Rows are frequency-major, as in the Pallas kernel: x is [F', B, C] and the
carries [NB, F', B, C], so the batch axis is one axis the serving engine
can infer.

* `plan_dprnn_stack` packs folded rf_blocks params into stacked,
  pre-transposed arrays with the Pallas plan's keys and shapes.
* `dprnn_stack_reference` is the plain PyTorch version of the kernel's
  math, with the Pallas kernel's cast points: float32 accumulation and gate
  math; the new carry rounded to the activation type; each fc output
  rounded before its residual and each residual sum rounded; the sweep's
  input projection (with b_ih) rounded before the recurrent half (with
  b_hh, in float32) is added; the sweep's h rounded for its product and
  its output and kept in float32 for the z * h term. The CPU path uses it;
  the card's checks compare the kernel against it.
* `dprnn_stack_step` is the wrapper: it checks the operands and calls the
  op `torch.ops.fastenhancer.dprnn_stack` (ops/_library.py), whose CPU
  implementation is the plain version (`cpu_impl`) and whose CUDA one
  launches the kernel or raises (`cuda_impl`); nothing falls back.
  The kernel has two forms, chosen by shape alone before launch
  (`kernel_form`): the tensor-core form (csrc/dprnn_tc.cuh) for bfloat16
  with Hd <= 32 whose shared memory fits, else the scalar form (float32
  always). `dprnn_stack_step.launches` counts launches of either form,
  `.tc_launches` those of the tensor-core form, both in `cuda_impl`;
  `launch_scalar` and
  `launch_tc` launch one form directly and count nothing.

What bounds the kernel on the H100, and what its design does about it, is
in the note at the top of csrc/dprnn_stack.cu.
"""
from __future__ import annotations

import ctypes
import typing as tp

import torch

from . import _build

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

PLAN_KEYS = ("w_xr", "w_hr", "b_r", "w_xz", "w_hz", "b_z",
             "w_xn", "w_hn", "b_xn", "b_hn", "w_tfc", "b_tfc",
             "w_fih", "b_fih", "w_fhh", "b_fhh", "w_ffc", "b_ffc")
MAX_SMEM_BYTES = _build.MAX_SMEM_BYTES
# x, h, x_out, h_out, the plan; B, F, C, Hd, NB; the stream (both forms)
_ARGTYPES = ([ctypes.c_void_p] * (4 + len(PLAN_KEYS)) + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
# the tensor-core form's widest sweep: one lane of a warp per hidden unit
TC_MAX_HIDDEN = 32


# ---------------------------------------------------------------------------
# Plan: folded block params -> stacked kernel-ready arrays
# ---------------------------------------------------------------------------

def plan_dprnn_stack(blocks: tp.Sequence[Params],
                     dtype: tp.Optional[torch.dtype] = None) -> Params:
    """Pack folded dprnn rf_blocks params (Model.fold() output: weight norm
    stripped, post-BNs merged into the fcs, pre-norms into the GRU input
    weights) into stacked, pre-transposed arrays with the block index
    leading; matrices are [in, out]. dtype=None keeps the blocks' own
    dtype. The time GRU's r and z biases sum b_ih + b_hh; its n gate keeps
    b_xn and b_hn apart (b_hn sits inside r * (h W_hn + b_hn))."""
    w_hh0 = blocks[0]["trnn"]["weight_hh"]
    if isinstance(w_hh0, dict):
        raise ValueError("plan_dprnn_stack expects fold() output "
                         "(weight norm still present)")
    dtype = w_hh0.dtype if dtype is None else dtype
    c = w_hh0.shape[1]

    def one(b: Params) -> Params:
        t = b["trnn"]
        out: Params = {}
        for j, g in enumerate("rzn"):
            rows = slice(j * c, (j + 1) * c)
            out[f"w_x{g}"] = t["weight_ih"][rows].T
            out[f"w_h{g}"] = t["weight_hh"][rows].T
        out["b_r"] = (t["bias_ih"][:c] + t["bias_hh"][:c])[None]
        out["b_z"] = (t["bias_ih"][c:2 * c] + t["bias_hh"][c:2 * c])[None]
        out["b_xn"] = t["bias_ih"][2 * c:][None]
        out["b_hn"] = t["bias_hh"][2 * c:][None]
        for name, key in (("trnn_fc", "tfc"), ("frnn_fc", "ffc")):
            fc = b[name]
            out[f"w_{key}"] = fc["weight"].T
            out[f"b_{key}"] = fc.get("bias", fc["weight"].new_zeros(c))[None]
        r = b["frnn"]
        out["w_fih"] = torch.stack([r[d]["weight_ih"].T for d in ("fwd", "bwd")])
        out["b_fih"] = torch.stack([r[d]["bias_ih"][None]
                                    for d in ("fwd", "bwd")])
        out["w_fhh"] = torch.stack([r[d]["weight_hh"].T for d in ("fwd", "bwd")])
        out["b_fhh"] = torch.stack([r[d]["bias_hh"][None]
                                    for d in ("fwd", "bwd")])
        return out

    per_block = [one(b) for b in blocks]
    return {k: torch.stack([p[k] for p in per_block]).to(dtype).contiguous()
            for k in PLAN_KEYS}


def plan_shapes(num_blocks: int, channels: int, hidden: int
                ) -> tp.Dict[str, tp.Tuple[int, ...]]:
    """Shape of each plan array, as `plan_dprnn_stack` makes it and the
    kernel reads it; hidden is the sweep's per-direction width."""
    nb, c, hd = num_blocks, channels, hidden
    shapes: tp.Dict[str, tp.Tuple[int, ...]] = {}
    for g in "rzn":
        shapes[f"w_x{g}"] = shapes[f"w_h{g}"] = (nb, c, c)
    for k in ("b_r", "b_z", "b_xn", "b_hn", "b_tfc", "b_ffc"):
        shapes[k] = (nb, 1, c)
    shapes.update(w_tfc=(nb, c, c), w_fih=(nb, 2, c, 3 * hd),
                  b_fih=(nb, 2, 1, 3 * hd), w_fhh=(nb, 2, hd, 3 * hd),
                  b_fhh=(nb, 2, 1, 3 * hd), w_ffc=(nb, 2 * hd, c))
    return {k: shapes[k] for k in PLAN_KEYS}


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel's math
# ---------------------------------------------------------------------------

def _gru_gates(xp: Tensor, hh: Tensor, h: Tensor) -> Tensor:
    """xp: input half (b_ih in), hh: recurrent half (b_hh in), h: the
    float32 state; torch gate order (r, z, n) -> h'."""
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    return (1.0 - z) * torch.tanh(xn + r * hn) + z * h


def dprnn_stack_reference(plan: Params, x: Tensor, h: Tensor
                          ) -> tp.Tuple[Tensor, Tensor]:
    """x: [F, B, C], h: [NB, F, B, C] -> (x_out [F, B, C], h_new like h).

    float32 accumulation and gate math; results rounded to x.dtype where
    the kernel rounds them (see the module docstring)."""
    fb, b, c = x.shape
    nb = h.shape[0]
    hd = plan["w_fhh"].shape[-2]
    dt = x.dtype
    rows = fb * b
    p = {k: v.float() for k, v in plan.items()}
    xs = x.reshape(rows, c)
    h_new = torch.empty_like(h)
    for i in range(nb):
        # --- time GRU step, trnn_fc + residual ---
        xf, hf = xs.float(), h[i].reshape(rows, c).float()
        r = torch.sigmoid(xf @ p["w_xr"][i] + hf @ p["w_hr"][i] + p["b_r"][i])
        z = torch.sigmoid(xf @ p["w_xz"][i] + hf @ p["w_hz"][i] + p["b_z"][i])
        n = torch.tanh(xf @ p["w_xn"][i] + p["b_xn"][i]
                       + r * (hf @ p["w_hn"][i] + p["b_hn"][i]))
        ht = ((1.0 - z) * n + z * hf).to(dt)
        h_new[i] = ht.reshape(fb, b, c)
        xs = (ht.float() @ p["w_tfc"][i] + p["b_tfc"][i]).to(dt) + xs
        # --- bidirectional sweep over the bins, both directions at once ---
        xp = (torch.matmul(xs.float(), p["w_fih"][i]) + p["b_fih"][i]).to(dt)
        xp = xp.reshape(2, fb, b, 3 * hd)
        hs = xs.new_zeros(2, b, hd, dtype=torch.float32)
        ys = torch.empty(fb, b, 2 * hd, dtype=dt, device=x.device)
        for f in range(fb):
            xin = torch.stack([xp[0, f], xp[1, fb - 1 - f]]).float()
            hh = torch.bmm(hs.to(dt).float(), p["w_fhh"][i]) + p["b_fhh"][i]
            hs = _gru_gates(xin, hh, hs)
            ys[f, :, :hd] = hs[0].to(dt)
            ys[fb - 1 - f, :, hd:] = hs[1].to(dt)
        xs = (ys.reshape(rows, 2 * hd).float() @ p["w_ffc"][i]
              + p["b_ffc"][i]).to(dt) + xs
    return xs.reshape(fb, b, c), h_new


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def smem_bytes(bins: int, channels: int, hidden: int) -> int:
    """Shared memory of one thread block (one stream): float32 activations,
    carry and new carry [3, F, C], the sweep output [F, 2Hd] and the
    sweep's double-buffered h and its state [3, 2, Hd]."""
    f, c, hd = bins, channels, hidden
    return 4 * (3 * f * c + f * 2 * hd + 3 * 2 * hd)


def tc_smem_bytes(bins: int, channels: int, hidden: int) -> int:
    """Shared memory of one thread block of the tensor-core form, as
    dprnn_tc.cuh's DprnnGeom counts it (bf16 elements): the zero chunk,
    the x, h and h' tiles, the sweep's input projection [F', 2, 3Hd] and
    output [F', 2Hd], and two weight slots (the largest stage, rows
    padded)."""
    f, c, hd = bins, channels, hidden
    ld, r8 = _build.ld_of, _build.round8
    g3, c8, v = 3 * hd, r8(c), r8(6 * hd)
    act = 3 * f * ld(c) + r8(f * 2 * g3) + f * ld(2 * hd)
    slot = max(6 * c * ld(c) + 4 * c8, c * ld(c) + c8,
               2 * c * ld(g3) + v + 2 * hd * ld(g3) + v,
               2 * hd * ld(c) + c8)
    return 2 * (16 + act + 2 * slot)


def kernel_form(bins: int, channels: int, hidden: int,
                dtype: torch.dtype) -> str:
    """Which form of the kernel runs, by shape alone, before launch: "tc"
    (tensor cores, csrc/dprnn_tc.cuh) for bfloat16 when Hd <= 32 and its
    shared memory fits; else "scalar" (the float32-FMA form, which float32
    always takes)."""
    if (dtype == torch.bfloat16 and hidden <= TC_MAX_HIDDEN
            and tc_smem_bytes(bins, channels, hidden) <= MAX_SMEM_BYTES):
        return "tc"
    return "scalar"


def _check(plan: Params, x: Tensor, h: Tensor) -> None:
    if x.ndim != 3 or h.ndim != 4:
        raise ValueError(f"x must be [F, B, C] and h [NB, F, B, C]; got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    fb, b, c = x.shape
    nb = h.shape[0]
    if b == 0:
        raise ValueError("need B >= 1")
    if tuple(h.shape) != (nb, fb, b, c):
        raise ValueError(f"h has shape {tuple(h.shape)}, expected "
                         f"{(nb, fb, b, c)}")
    shapes = plan_shapes(nb, c, plan["w_fhh"].shape[-2])
    for name, t in (("x", x), ("h", h), *((k, plan[k]) for k in PLAN_KEYS)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every "
                             f"operand must be {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"plan[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")


def _cuda_only(x: Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {x.device}")


def _launch(fn: tp.Callable[..., int], plan: Params, x: Tensor, h: Tensor
            ) -> tp.Tuple[Tensor, Tensor]:
    fb, b, c = x.shape
    x_out = torch.empty_like(x)
    h_out = torch.empty_like(h)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), x_out.data_ptr(),
                 h_out.data_ptr(), *(plan[k].data_ptr() for k in PLAN_KEYS),
                 b, fb, c, plan["w_fhh"].shape[-2], h.shape[0], stream)
    _build.check_launch("dprnn_stack", err)
    return x_out, h_out


def launch_scalar(plan: Params, x: Tensor, h: Tensor
                  ) -> tp.Tuple[Tensor, Tensor]:
    """Launch the scalar form (one thread block per stream) on CUDA tensors
    that passed _check; counts nothing."""
    _cuda_only(x)
    fb, _, c = x.shape
    hd = plan["w_fhh"].shape[-2]
    smem = smem_bytes(fb, c, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"F={fb}, C={c}, Hd={hd} needs {smem} bytes of shared memory "
            f"per stream; the kernel has {MAX_SMEM_BYTES}")
    return _launch(_build.entry("dprnn_stack", x.dtype, _ARGTYPES), plan, x,
                   h)


def launch_tc(plan: Params, x: Tensor, h: Tensor
              ) -> tp.Tuple[Tensor, Tensor]:
    """Launch the tensor-core form on bfloat16 CUDA tensors that passed
    _check and whose shape kernel_form gives to it; counts nothing."""
    fb, _, c = x.shape
    hd = plan["w_fhh"].shape[-2]
    if kernel_form(fb, c, hd, x.dtype) != "tc":
        raise ValueError(f"the tensor-core form does not take F={fb}, C={c}, "
                         f"Hd={hd} in {x.dtype} (see kernel_form)")
    _cuda_only(x)
    return _launch(_build.function("dprnn_stack", "dprnn_stack_tc_bf16",
                                   ctypes.c_int, _ARGTYPES), plan, x, h)


def dprnn_stack_step(plan: Params, x: Tensor, h: Tensor
                     ) -> tp.Tuple[Tensor, Tensor]:
    """One streaming frame through every block.

    x: [F, B, C] frame activations (rf_pre output, frequency-major); h:
    [NB, F, B, C] stacked time-GRU carries -> (x_out [F, B, C], h_new like
    h), fresh tensors. Every operand has x's dtype (float32 or bfloat16)
    and device and is contiguous. The op `torch.ops.fastenhancer.
    dprnn_stack` (ops/_library.py): on the CPU the plain version; on a
    CUDA device it launches the form `kernel_form` picks (building the
    kernel on first use), one thread block per stream, and raises if it
    cannot."""
    _check(plan, x, h)
    _build.check_device(x)
    return tuple(torch.ops.fastenhancer.dprnn_stack(
        [plan[k] for k in PLAN_KEYS], x, h))


def cpu_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor
             ) -> tp.Tuple[Tensor, Tensor]:
    """The op's CPU implementation: the plain version."""
    return dprnn_stack_reference(dict(zip(PLAN_KEYS, plan)), x, h)


def fake_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor
              ) -> tp.Tuple[Tensor, Tensor]:
    """The op's shapes and types: x_out like x, h_new like h."""
    return torch.empty_like(x), torch.empty_like(h)


def cuda_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor
              ) -> tp.Tuple[Tensor, Tensor]:
    """The op's CUDA implementation: one launch of the form kernel_form
    picks, counted in dprnn_stack_step.launches (and .tc_launches)."""
    plan = dict(zip(PLAN_KEYS, plan))
    fb, _, c = x.shape
    if kernel_form(fb, c, plan["w_fhh"].shape[-2], x.dtype) == "tc":
        out = launch_tc(plan, x, h)
        dprnn_stack_step.tc_launches += 1
    else:
        out = launch_scalar(plan, x, h)
    dprnn_stack_step.launches += 1
    return out


dprnn_stack_step.launches = 0
dprnn_stack_step.tc_launches = 0
