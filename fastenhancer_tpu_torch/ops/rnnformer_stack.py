"""The RNNFormer block stack for one streaming frame: plan, plain version and
the wrapper of the hand-written CUDA kernel (csrc/rnnformer_stack.cu).

Replaces fastenhancer_tpu/ops/rnnformer_stack.py::rnnformer_stack_step (the
Pallas TPU kernel) for the folded default block form. Per block: one GRU
step, rnn_fc plus residual, the positional embedding, H-head frequency
self-attention, attn_fc plus residual.

* `plan_stack` packs folded rf_blocks params into stacked, pre-transposed
  arrays. It keeps only the real weights: the TPU plan's frequency padding,
  lane masks and head masks are not needed here.
* `rnnformer_stack_reference` is the plain PyTorch version of the kernel's
  math, with the same float32 accumulation and the same rounding points to
  the activation dtype. The CPU path uses it, and the card's checks compare
  the kernel against it.
* `rnnformer_stack_step` is the wrapper: a CPU tensor goes to the plain
  version, a CUDA tensor launches the kernel or raises; nothing falls back.
  `rnnformer_stack_step.launches` counts kernel launches.

What bounds the kernel on the H100, and what its design does about it, is
in the note at the top of csrc/rnnformer_stack.cu: at B=256 streams the
frame is tiny, so it is latency- and launch-bound rather than FLOP-bound,
and the kernel runs the whole stack in one launch with one thread block per
stream and every activation in shared memory.
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
# Hopper's largest dynamic shared memory per thread block (227 KB)
MAX_SMEM_BYTES = 232_448
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


# ---------------------------------------------------------------------------
# Plan: folded block params -> stacked kernel-ready arrays
# ---------------------------------------------------------------------------

def plan_stack(blocks: tp.Sequence[Params], freq: int, num_heads: int,
               dtype: tp.Optional[torch.dtype] = None) -> Params:
    """Pack folded rf_blocks params (Model.fold() output: weight norm
    stripped, post-norms merged into the fcs, no pre-norms) into stacked
    arrays with the block index leading; matrices are [in, out]. dtype=None
    keeps the blocks' own dtype.

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
    return {k: torch.stack([p[k] for p in per_block]).to(dtype).contiguous()
            for k in PLAN_KEYS}


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel's math
# ---------------------------------------------------------------------------

def rnnformer_stack_reference(plan: Params, x: Tensor, h: Tensor,
                              num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """x: [B, F, C], h: [NB, B*F, C] -> (x_out [B, F, C], h_new [NB, B*F, C]).

    float32 accumulation and gate/softmax math; results rounded to x.dtype
    where the kernel rounds them. The softmax uses each head's own max."""
    b, f, c = x.shape
    nb = h.shape[0]
    dt = x.dtype
    d = c // num_heads
    scale = 1.0 / math.sqrt(d)
    p = {k: v.float() for k, v in plan.items()}
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
        xs = y + xs
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
        xs = y + xs
    return xs.reshape(b, f, c), torch.stack(h_new)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def plan_shapes(num_blocks: int, freq: int, channels: int
                ) -> tp.Dict[str, tp.Tuple[int, ...]]:
    """Shape of each plan array, as `plan_stack` makes it and the kernel
    reads it."""
    nb, f, c = num_blocks, freq, channels
    return {"w_x": (nb, 3, c, c), "w_h": (nb, 3, c, c), "b_gru": (nb, 4, c),
            "w_fc": (nb, c, c), "b_fc": (nb, c), "w_qkv": (nb, 3, c, c),
            "b_qkv": (nb, 3, c), "w_afc": (nb, c, c), "b_afc": (nb, c),
            "pe": (nb, f, c)}


def smem_bytes(freq: int, channels: int, num_heads: int) -> int:
    """Shared memory of one thread block (one stream): six [F, C] float32
    buffers and the [H, F, F] logits."""
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
    shapes = plan_shapes(nb, f, c)
    for name, t in (("x", x), ("h", h),
                    *((k, plan[k]) for k in PLAN_KEYS)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every "
                             f"operand must be {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"plan[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")


_BOUND: tp.Dict[str, tp.Callable[..., int]] = {}


def _kernel(dtype: torch.dtype) -> tp.Callable[..., int]:
    """The C entry for `dtype`, with its ctypes signature declared: every
    pointer and the stream as c_void_p (an undeclared Python int would be
    passed as a 32-bit int)."""
    fn = _BOUND.get(_DTYPES[dtype])
    if fn is None:
        lib = _build.load_library("rnnformer_stack")
        lib.rnnformer_stack_error_string.restype = ctypes.c_char_p
        lib.rnnformer_stack_error_string.argtypes = [ctypes.c_int]
        for suffix in _DTYPES.values():
            f = getattr(lib, f"rnnformer_stack_{suffix}")
            f.restype = ctypes.c_int
            f.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
            _BOUND[suffix] = f
        fn = _BOUND[_DTYPES[dtype]]
    return fn


def rnnformer_stack_step(plan: Params, x: Tensor, h: Tensor,
                         num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """One streaming frame through every block.

    x: [B, F, C] frame activations (rf_pre output), h: [NB, B*F, C] stacked
    GRU carries, rows batch-major -> (x_out [B, F, C], h_new [NB, B*F, C]),
    fresh tensors. Every operand has x's dtype (float32 or bfloat16) and
    device and is contiguous. On the CPU this is the plain version; on a
    CUDA device it launches the kernel (building it on first use) and raises
    if it cannot."""
    _check(plan, x, h, num_heads)
    if x.device.type == "cpu":
        return rnnformer_stack_reference(plan, x, h, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not "
                         f"{x.dtype}")
    b, f, c = x.shape
    smem = smem_bytes(f, c, num_heads)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"F={f}, C={c}, H={num_heads} needs {smem} bytes of shared "
            f"memory per stream; the kernel has {MAX_SMEM_BYTES}")
    fn = _kernel(x.dtype)
    x_out = torch.empty_like(x)
    h_out = torch.empty_like(h)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), x_out.data_ptr(),
                 h_out.data_ptr(), *(plan[k].data_ptr() for k in PLAN_KEYS),
                 b, f, c, num_heads, h.shape[0], stream)
    if err:
        lib = _build.load_library("rnnformer_stack")
        msg = lib.rnnformer_stack_error_string(err).decode()
        raise RuntimeError(f"rnnformer_stack kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    rnnformer_stack_step.launches += 1
    return x_out, h_out


rnnformer_stack_step.launches = 0
