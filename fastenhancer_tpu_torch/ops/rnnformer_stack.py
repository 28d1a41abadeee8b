"""The RNNFormer block stack for one streaming frame: plan, plain version and
the wrapper of the hand-written CUDA kernel (csrc/rnnformer_stack.cu).

Replaces fastenhancer_tpu/ops/rnnformer_stack.py::rnnformer_stack_step (the
Pallas TPU kernel) in both its forms. Per block: one GRU step, rnn_fc plus
residual, the positional embedding, H-head frequency self-attention,
attn_fc plus residual. The folded default block form has its post-norms
merged into the fcs; the ln ablation's form (a plan built with `ln_eps`)
applies a LayerNorm over each stream's [F, C] tile to each fc's output
before its residual, with the reference's affine quirk
`diff + rsqrt(var + eps) * (weight * bias)`: the normalized diff is never
scaled (the Pallas kernel's `stack_math(ln=True)`).

* `plan_stack` packs folded rf_blocks params into stacked, pre-transposed
  arrays. It keeps only the real weights: the TPU plan's frequency padding,
  lane masks and head masks are not needed here.
* `rnnformer_stack_reference` is the plain PyTorch version of the kernel's
  math, with the same float32 accumulation and the same rounding points to
  the activation dtype. The CPU path uses it, and the card's checks compare
  the kernel against it.
* `rnnformer_stack_step` is the wrapper: it checks the operands and calls
  the op `torch.ops.fastenhancer.rnnformer_stack` (ops/_library.py), whose
  CPU implementation is the plain version (`cpu_impl`) and whose CUDA one
  launches the kernel or raises (`cuda_impl`); nothing falls back.
  `rnnformer_stack_step.launches` counts launches of the folded default
  form and `rnnformer_stack_step.ln_launches` those of the LN form, both in
  `cuda_impl`, so an exported program's launches count too.

What bounds the kernel on the H100, and what its design does about it, is
in the note at the top of csrc/rnnformer_stack.cu: at B=256 streams the
frame is tiny, so it is latency- and launch-bound rather than FLOP-bound,
and the kernel runs the whole stack in one launch with one thread block per
stream and every activation in shared memory. The bfloat16 forms run their
products on the tensor cores with weights staged in shared memory
(csrc/stack_tc.cuh); the float32 forms keep scalar float32 FMA chains as
the card's correctness reference.
"""
from __future__ import annotations

import ctypes
import math
import typing as tp

import torch

from . import _build

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

PLAN_KEYS = ("w_x", "w_h", "b_gru", "w_fc", "b_fc", "w_qkv", "b_qkv",
             "w_afc", "b_afc", "pe")
# the LN form's extra arrays: each post-norm's weight * bias, [NB, C]; its
# plan also holds the LayerNorm's eps as a float under "ln_eps"
LN_KEYS = ("wb_fc", "wb_afc")
MAX_SMEM_BYTES = _build.MAX_SMEM_BYTES
# x, h, x_out, h_out, the plan, wb_fc and wb_afc (null for the folded
# default form); B, F, C, H, NB; eps; the stream
_ARGTYPES = ([ctypes.c_void_p] * (4 + len(PLAN_KEYS) + len(LN_KEYS))
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])


# ---------------------------------------------------------------------------
# Plan: folded block params -> stacked kernel-ready arrays
# ---------------------------------------------------------------------------

def plan_stack(blocks: tp.Sequence[Params], freq: int, num_heads: int,
               dtype: tp.Optional[torch.dtype] = None,
               ln_eps: tp.Optional[float] = None) -> Params:
    """Pack folded rf_blocks params (Model.fold() output: weight norm
    stripped, post-norms merged into the fcs, no pre-norms) into stacked
    arrays with the block index leading; matrices are [in, out]. dtype=None
    keeps the blocks' own dtype.

    ln_eps selects the ln ablation's form (models/fastenhancer/ln.py): its
    post-norms are LayerNorms over [F, C] that cannot fold, so the blocks
    keep {"ln": {"weight", "bias"}} under rnn_post_norm and attn_post_norm,
    and the plan gains wb_fc and wb_afc, each [NB, C]: weight * bias taken
    in float32, then cast to the plan's dtype (the reference's quirky affine
    term), and "ln_eps" as a float. The statistics run over exactly F x C
    (no frequency padding here, so the Pallas plan's fmask has no
    counterpart).

    The reference qkv weight rows are per head [q_h | k_h | v_h]; they are
    gathered so that output column h*d + t of w_qkv[:, 0/1/2] is head h,
    dim t of q/k/v. b_gru holds b_ir + b_hr and b_iz + b_hz summed, while
    b_in and b_hn stay apart (b_hn sits inside r * (h W_hn + b_hn)). pe is
    zero for blocks without a positional embedding (only block 0 has one)."""
    w_hh0 = blocks[0]["rnn"]["weight_hh"]
    if isinstance(w_hh0, dict):
        raise ValueError("plan_stack expects fold() output "
                         "(weight norm still present)")
    dtype = w_hh0.dtype if dtype is None else dtype
    device = w_hh0.device
    c = w_hh0.shape[1]
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by heads {num_heads}")
    d = c // num_heads
    lane = torch.arange(c, device=device)
    q_rows = (lane // d) * 3 * d + lane % d
    zeros = torch.zeros(3 * c, dtype=w_hh0.dtype, device=device)

    def gates(w: Tensor) -> Tensor:  # [3C, C] torch rows -> [3, C_in, C_out]
        return torch.stack([w[g * c:(g + 1) * c].T for g in range(3)])

    def one(b: Params) -> Params:
        rnn, qkv = b["rnn"], b["attn"]["qkv"]
        b_ih, b_hh = rnn["bias_ih"], rnn["bias_hh"]
        qkv_b = qkv.get("bias", zeros)
        pe = b.get("pe")
        return {
            "w_x": gates(rnn["weight_ih"]),
            "w_h": gates(rnn["weight_hh"]),
            "b_gru": torch.stack([b_ih[:c] + b_hh[:c],
                                  b_ih[c:2 * c] + b_hh[c:2 * c],
                                  b_ih[2 * c:], b_hh[2 * c:]]),
            "w_fc": b["rnn_fc"]["weight"].T,
            "b_fc": b["rnn_fc"].get("bias", zeros[:c]),
            "w_qkv": torch.stack([qkv["weight"][q_rows + o * d].T
                                  for o in range(3)]),
            "b_qkv": torch.stack([qkv_b[q_rows + o * d] for o in range(3)]),
            "w_afc": b["attn_fc"]["weight"].T,
            "b_afc": b["attn_fc"].get("bias", zeros[:c]),
            "pe": (pe["weight"] if pe is not None
                   else torch.zeros(freq, c, dtype=w_hh0.dtype,
                                    device=device)),
        }

    per_block = [one(b) for b in blocks]
    plan = {k: torch.stack([p[k] for p in per_block]).to(dtype).contiguous()
            for k in PLAN_KEYS}
    if ln_eps is not None:
        for key, norm in (("wb_fc", "rnn_post_norm"),
                          ("wb_afc", "attn_post_norm")):
            plan[key] = torch.stack([
                b[norm]["ln"]["weight"].float() * b[norm]["ln"]["bias"].float()
                for b in blocks]).to(dtype).contiguous()
        plan["ln_eps"] = float(ln_eps)
    return plan


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel's math
# ---------------------------------------------------------------------------

def rnnformer_stack_reference(plan: Params, x: Tensor, h: Tensor,
                              num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """x: [B, F, C], h: [NB, B*F, C] -> (x_out [B, F, C], h_new [NB, B*F, C]).

    float32 accumulation and gate/softmax math; results rounded to x.dtype
    where the kernel rounds them. The softmax uses each head's own max. A
    plan with wb_fc (the LN form) normalizes each fc output, rounded to
    x.dtype, over its stream's [F, C] in float32, rounds the result to
    x.dtype and only then adds the residual."""
    b, f, c = x.shape
    nb = h.shape[0]
    dt = x.dtype
    d = c // num_heads
    scale = 1.0 / math.sqrt(d)
    ln = "wb_fc" in plan
    p = {k: v.float() for k, v in plan.items() if isinstance(v, Tensor)}

    def post_norm(y: Tensor, key: str, i: int) -> Tensor:
        """y [B*F, C] in dt -> the LN form's normalized y, or y as it is."""
        if not ln:
            return y
        yf = y.float().reshape(b, f, c)
        diff = yf - yf.mean(dim=(1, 2), keepdim=True)
        var = diff.square().mean(dim=(1, 2), keepdim=True)
        out = diff + torch.rsqrt(var + plan["ln_eps"]) * p[key][i]
        return out.reshape(b * f, c).to(dt)

    xs = x.reshape(b * f, c)
    h_new = []
    for i in range(nb):
        xf, hf = xs.float(), h[i].float()
        bg = p["b_gru"][i]
        r = torch.sigmoid(xf @ p["w_x"][i, 0] + hf @ p["w_h"][i, 0] + bg[0])
        z = torch.sigmoid(xf @ p["w_x"][i, 1] + hf @ p["w_h"][i, 1] + bg[1])
        n = torch.tanh(xf @ p["w_x"][i, 2] + bg[2]
                       + r * (hf @ p["w_h"][i, 2] + bg[3]))
        hn = ((1.0 - z) * n + z * hf).to(dt)
        h_new.append(hn)
        y = (hn.float() @ p["w_fc"][i] + p["b_fc"][i]).to(dt)
        xs = post_norm(y, "wb_fc", i) + xs
        xs = (xs.reshape(b, f, c) + plan["pe"][i]).reshape(b * f, c)
        xf = xs.float()
        q, k, v = [(xf @ p["w_qkv"][i, o] + p["b_qkv"][i, o]).to(dt)
                   for o in range(3)]
        q, k, v = [t.float().reshape(b, f, num_heads, d) for t in (q, k, v)]
        logits = torch.einsum("bfhd,bghd->bhfg", q, k) * scale
        probs = torch.softmax(logits, dim=-1).to(dt).float()
        attn = torch.einsum("bhfg,bghd->bfhd", probs, v)
        attn = attn.reshape(b * f, c).to(dt)
        y = (attn.float() @ p["w_afc"][i] + p["b_afc"][i]).to(dt)
        xs = post_norm(y, "wb_afc", i) + xs
    return xs.reshape(b, f, c), torch.stack(h_new)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def plan_shapes(num_blocks: int, freq: int, channels: int,
                ln: bool = False) -> tp.Dict[str, tp.Tuple[int, ...]]:
    """Shape of each plan array, as `plan_stack` makes it and the kernel
    reads it; ln=True adds the LN form's wb_fc and wb_afc."""
    nb, f, c = num_blocks, freq, channels
    shapes = {"w_x": (nb, 3, c, c), "w_h": (nb, 3, c, c),
              "b_gru": (nb, 4, c), "w_fc": (nb, c, c), "b_fc": (nb, c),
              "w_qkv": (nb, 3, c, c), "b_qkv": (nb, 3, c),
              "w_afc": (nb, c, c), "b_afc": (nb, c), "pe": (nb, f, c)}
    if ln:
        shapes.update(wb_fc=(nb, c), wb_afc=(nb, c))
    return shapes


def smem_bytes(freq: int, channels: int, num_heads: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one thread block (one stream). float32: six [F, C]
    float32 buffers and the [H, F, F] logits. bfloat16 (the tensor-core
    form): as the kernel's library computes it (bf16 tiles, the logits and
    two weight slots); this builds the library."""
    if dtype == torch.bfloat16:
        fn = _build.function("rnnformer_stack", "rnnformer_stack_smem_bf16",
                             ctypes.c_size_t, [ctypes.c_int] * 3)
        return int(fn(freq, channels, num_heads))
    return 4 * (6 * freq * channels + num_heads * freq * freq)


def _check(plan: Params, x: Tensor, h: Tensor, num_heads: int) -> None:
    if x.ndim != 3 or h.ndim != 3:
        raise ValueError(f"x must be [B, F, C] and h [NB, B*F, C]; got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    b, f, c = x.shape
    nb = h.shape[0]
    if b == 0 or c % num_heads:
        raise ValueError(f"need B >= 1 and C % H == 0; got B={b}, C={c}, "
                         f"H={num_heads}")
    if tuple(h.shape) != (nb, b * f, c):
        raise ValueError(f"h has shape {tuple(h.shape)}, expected "
                         f"{(nb, b * f, c)}")
    ln = "wb_fc" in plan
    if ln and not isinstance(plan.get("ln_eps"), float):
        raise ValueError("an LN plan needs its eps as a float under "
                         "'ln_eps' (plan_stack(..., ln_eps=...))")
    shapes = plan_shapes(nb, f, c, ln)
    for name, t in (("x", x), ("h", h),
                    *((k, plan[k]) for k in shapes)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every "
                             f"operand must be {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"plan[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")


def plan_tensors(plan: Params) -> tp.List[Tensor]:
    """The plan's arrays as the op takes them: PLAN_KEYS in order, then
    LN_KEYS for the LN form."""
    keys = PLAN_KEYS + (LN_KEYS if "wb_fc" in plan else ())
    return [plan[k] for k in keys]


def _plan_dict(tensors: tp.Sequence[Tensor],
               ln_eps: tp.Optional[float]) -> Params:
    """plan_tensors' list (and the LN form's eps) -> the plan dict."""
    plan = dict(zip(PLAN_KEYS + LN_KEYS, tensors))
    if ln_eps is not None:
        plan["ln_eps"] = ln_eps
    return plan


def rnnformer_stack_step(plan: Params, x: Tensor, h: Tensor,
                         num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """One streaming frame through every block.

    x: [B, F, C] frame activations (rf_pre output), h: [NB, B*F, C] stacked
    GRU carries, rows batch-major -> (x_out [B, F, C], h_new [NB, B*F, C]),
    fresh tensors. Every operand has x's dtype (float32 or bfloat16) and
    device and is contiguous. A plan with wb_fc (plan_stack's ln_eps) runs
    the LN form. The op `torch.ops.fastenhancer.rnnformer_stack`
    (ops/_library.py): on the CPU the plain version; on a CUDA device it
    launches the kernel (building it on first use) and raises if it
    cannot."""
    _check(plan, x, h, num_heads)
    _build.check_device(x)
    ln_eps = plan["ln_eps"] if "wb_fc" in plan else None
    return tuple(torch.ops.fastenhancer.rnnformer_stack(
        plan_tensors(plan), x, h, num_heads, ln_eps))


def cpu_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor, num_heads: int,
             ln_eps: tp.Optional[float]) -> tp.Tuple[Tensor, Tensor]:
    """The op's CPU implementation: the plain version."""
    return rnnformer_stack_reference(_plan_dict(plan, ln_eps), x, h,
                                     num_heads)


def fake_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor, num_heads: int,
              ln_eps: tp.Optional[float]) -> tp.Tuple[Tensor, Tensor]:
    """The op's shapes and types: x_out like x, h_new like h."""
    return torch.empty_like(x), torch.empty_like(h)


def cuda_impl(plan: tp.List[Tensor], x: Tensor, h: Tensor, num_heads: int,
              ln_eps: tp.Optional[float]) -> tp.Tuple[Tensor, Tensor]:
    """The op's CUDA implementation: one launch of the kernel, counted in
    rnnformer_stack_step.launches (ln_launches for the LN form)."""
    fn = _build.entry("rnnformer_stack", x.dtype, _ARGTYPES)
    b, f, c = x.shape
    smem = smem_bytes(f, c, num_heads, x.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"F={f}, C={c}, H={num_heads} needs {smem} bytes of shared "
            f"memory per stream; the kernel has {MAX_SMEM_BYTES}")
    ln = ln_eps is not None
    ptrs = [t.data_ptr() for t in plan]
    if not ln:
        ptrs += [None, None]  # no wb_fc, wb_afc
    x_out = torch.empty_like(x)
    h_out = torch.empty_like(h)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), x_out.data_ptr(),
                 h_out.data_ptr(), *ptrs, b, f, c, num_heads, h.shape[0],
                 ln_eps if ln else 0.0, stream)
    _build.check_launch("rnnformer_stack", err)
    if ln:
        rnnformer_stack_step.ln_launches += 1
    else:
        rnnformer_stack_step.launches += 1
    return x_out, h_out


rnnformer_stack_step.launches = 0
rnnformer_stack_step.ln_launches = 0
