"""FastEnhancer's whole spec->mask model for one streaming frame: plan,
plain version and the wrapper of the hand-written CUDA kernel
(csrc/fused_frame.cu).

Replaces fastenhancer_tpu/ops/fused_frame.py::fused_frame_step (the Pallas
TPU kernel) for the folded `fastenhancer.default` form: the strided PreNet
conv, the encoder's frequency convs, rf_pre (frequency resample + 1x1
conv), the RNNFormer block stack (ops/rnnformer_stack.py's math), rf_post,
the decoder with its skip concats, dec_post, the stride-s ConvTranspose
and the mask activation, in one launch per frame. Only the STFT/iSTFT
steps and the complex mask multiply stay outside.

How the pieces map (the Pallas kernel's forms, kept in the plan):
* the PreNet arrives strided-reshaped ([B, F_enc+1, 2s]), so it is a 2-tap
  valid conv; the encoder and decoder convs are k shifted taps on
  zero-padded rows;
* a skip concat followed by a 1x1 conv is a split-weight sum,
  x @ W_x + skip @ W_s;
* the stride-s ConvTranspose1d with k = 2s is s phases of two taps each,
  emitted as [B, F_enc, 2s] (phase-interleaved) and reshaped outside to
  [B, F_enc*s, 2].

* `plan_frame` checks the envelope and packs the folded variables.
* `fused_frame_reference` is the plain PyTorch version of the kernel's
  math, with float32 accumulation and the same rounding points to the
  activation type. The CPU path uses it; the card's checks compare the
  kernel against it.
* `fused_frame_step` is the wrapper: it checks the operands and calls the
  op `torch.ops.fastenhancer.fused_frame` (ops/_library.py), whose CPU
  implementation is the plain version (`cpu_impl`) and whose CUDA one
  launches the kernel or raises (`cuda_impl`); nothing falls back.
  `fused_frame_step.launches` counts kernel launches, in `cuda_impl`.

What bounds the kernel on the H100, and what its design does about it, is
in the note at the top of csrc/fused_frame.cu (the bfloat16 form on the
tensor cores, the float32 form scalar).
"""
from __future__ import annotations

import ctypes
import typing as tp

import torch
import torch.nn.functional as F

from . import _build
from ..utils.tree import tree_leaves, tree_paths
from .rnnformer_stack import (PLAN_KEYS as STACK_KEYS, _check as _check_stack,
                              plan_stack, rnnformer_stack_reference)

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

MAX_SMEM_BYTES = _build.MAX_SMEM_BYTES
# encoder convs the kernel's plan struct has room for (FE T/B/S have 2-3)
MAX_ENC = 6
MASKS = (None, "sigmoid", "tanh")
# x, h, mask8, h_out; the frame plan's pointer table and its length; the
# stack plan's pointer table; the size table and its length; the stream
_ARGTYPES = ([ctypes.c_void_p] * 4
             + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])


def frame_plan_keys(n_enc: int) -> tp.List[str]:
    """The frame plan's arrays besides "stack", in the kernel's order."""
    keys = ["w_enc_pre", "b_enc_pre"]
    for i in range(n_enc):
        keys += [f"w_enc{i}", f"b_enc{i}"]
    keys += ["w_rf_pre_lin", "w_rf_pre", "b_rf_pre",
             "w_rf_post_lin", "w_rf_post", "b_rf_post"]
    for i in range(n_enc):
        keys += [f"w_dec{i}_x", f"w_dec{i}_s", f"b_dec{i}_1",
                 f"w_dec{i}_2", f"b_dec{i}_2"]
    keys += ["w_post_x", "w_post_s", "b_post",
             "w_convt_a", "w_convt_b", "b_convt"]
    return keys


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

def _taps(conv: Params) -> Tensor:
    """torch conv weight [Cout, Cin, K] -> K stacked matrices [K, Cin, Cout]."""
    return conv["weight"].permute(2, 1, 0)


def plan_frame(model, variables: Params,
               dtype: tp.Optional[torch.dtype] = None) -> Params:
    """Pack a folded fastenhancer.default model for the whole-frame kernel.
    Raises ValueError outside the kernel's envelope: unfolded variables,
    a GroupNorm or LayerNorm anywhere (the ln ablation: a folded tree keeps
    them, with no statistics), a conv other than 1-D (the time_kernel
    ablation's 2-D causal convs), kernel_size[0] != 2 * stride, an
    activation other than SiLU, a mask other than None/sigmoid/tanh,
    post_act, or other than RNNFormer blocks. dtype=None keeps the
    variables' own dtype."""
    if tree_leaves(variables["stats"]):
        raise ValueError("plan_frame expects fold() output")
    for path, leaf in tree_paths(variables["params"]):
        if {"gn", "gn1", "gn2", "ln"} & set(path):
            raise ValueError(f"fused frame has no GroupNorm or LayerNorm "
                             f"form (found {'.'.join(path)})")
        if path[-2].startswith("conv") and path[-1] == "weight" \
                and leaf.ndim != 3:
            raise ValueError(f"fused frame runs 1-D convs only (found a "
                             f"{leaf.ndim}-D weight at {'.'.join(path)})")
    if model.kernel_size[0] != 2 * model.stride:
        raise ValueError("fused frame supports kernel_size[0] == 2*stride")
    if model.activation != "SiLU":
        raise ValueError("fused frame supports SiLU activation only")
    if model.mask_name not in MASKS:
        raise ValueError(f"unsupported mask activation {model.mask_name!r}")
    if model.rf.post_act:
        raise ValueError("fused frame: post_act recipes unsupported")
    p = variables["params"]
    if "rnn" not in p["rf_blocks"][0]:
        raise ValueError("fused frame runs RNNFormer (time-GRU) blocks only")
    n_enc = len(model.kernel_size) - 1
    if n_enc > MAX_ENC:
        raise ValueError(f"fused frame takes at most {MAX_ENC} encoder "
                         f"convs, not {n_enc}")
    dtype = p["rf_blocks"][0]["rnn"]["weight_hh"].dtype if dtype is None \
        else dtype

    plan: Params = {
        "w_enc_pre": _taps(p["enc_pre"]["conv"]),          # [2, 2s, C]
        "b_enc_pre": p["enc_pre"]["conv"]["bias"],
    }
    for i, ep in enumerate(p["encoder"]):
        plan[f"w_enc{i}"] = _taps(ep["conv"])               # [k, C, C]
        plan[f"b_enc{i}"] = ep["conv"]["bias"]
    for name in ("rf_pre", "rf_post"):
        plan[f"w_{name}_lin"] = p[name]["lin"]["weight"].T  # [F_in, F_out]
        plan[f"w_{name}"] = _taps(p[name]["conv"])[0]       # [C_in, C_out]
        plan[f"b_{name}"] = p[name]["conv"]["bias"]
    c = model.channels
    for i, dp in enumerate(p["decoder"]):
        w1 = dp["conv1"]["weight"][:, :, 0]                 # [C, 2C]
        plan[f"w_dec{i}_x"] = w1[:, :c].T
        plan[f"w_dec{i}_s"] = w1[:, c:].T
        plan[f"b_dec{i}_1"] = dp["conv1"]["bias"]
        plan[f"w_dec{i}_2"] = _taps(dp["conv2"])
        plan[f"b_dec{i}_2"] = dp["conv2"]["bias"]
    wp = p["dec_post"]["conv"]["weight"][:, :, 0]
    plan["w_post_x"] = wp[:, :c].T
    plan["w_post_s"] = wp[:, c:].T
    plan["b_post"] = p["dec_post"]["conv"]["bias"]
    # ConvTranspose1d(stride s, k = 2s, pad s/2): output position s*m + r is
    #   x[m] @ W[:, :, r + s/2] + x[m-1] @ W[:, :, r + 3s/2]   (r <  s/2)
    #   x[m] @ W[:, :, r + s/2] + x[m+1] @ W[:, :, r - s/2]    (r >= s/2)
    wt = p["dec_post"]["convt"]["weight"]                   # [C, 2, 2s]
    s = model.stride
    half = s // 2
    plan["w_convt_a"] = torch.stack([wt[:, :, r + half] for r in range(s)])
    plan["w_convt_b"] = torch.stack(
        [wt[:, :, r + half + s] if r < half else wt[:, :, r + half - s]
         for r in range(s)])                                # [s, C, 2]
    # phase-interleaved output columns [r0o0, r0o1, r1o0, ...]
    plan["b_convt"] = p["dec_post"]["convt"]["bias"].repeat(s)
    plan = {k: v.to(dtype).contiguous() for k, v in plan.items()}
    plan["stack"] = plan_stack(p["rf_blocks"], model.block_freq,
                               model.rf.num_heads, dtype=dtype)
    return plan


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel's math
# ---------------------------------------------------------------------------

def _silu(acc: Tensor, dt: torch.dtype) -> Tensor:
    """float32 sum -> rounded to dt, SiLU in float32, rounded to dt."""
    return F.silu(acc.to(dt).float()).to(dt)


def _conv_k(x: Tensor, taps: Tensor, bias: Tensor) -> Tensor:
    """Same-padded k-tap frequency conv of [B, F, C] as k shifted matmuls;
    float32 sum with the bias."""
    k = taps.shape[0]
    f = x.shape[1]
    pad = (k - 1) // 2
    xp = F.pad(x.float(), (0, 0, pad, k - 1 - pad))
    acc = bias.float()
    for j in range(k):
        acc = acc + xp[:, j:j + f] @ taps[j].float()
    return acc


def fused_frame_reference(plan: Params, x: Tensor, h: Tensor, *,
                          num_heads: int, n_enc: int,
                          enc_ks: tp.Sequence[int], f_enc: int,
                          block_freq: int, stride: int, resnet: bool,
                          mask: tp.Optional[str]) -> tp.Tuple[Tensor, Tensor]:
    """x: [B, F_enc+1, 2s], h: [NB, B*F', C'] -> (mask8 [B, F_enc, 2s],
    h_new). float32 accumulation; results rounded to x.dtype where the
    Pallas kernel rounds: each conv/linear output, each SiLU, each residual
    sum; the ConvTranspose phases and the mask stay float32 until the
    output."""
    dt = x.dtype
    b = x.shape[0]
    p = {k: v.float() for k, v in plan.items() if k != "stack"}
    w = p["w_enc_pre"]
    xf = x.float()
    y = _silu(xf[:, :f_enc] @ w[0] + xf[:, 1:] @ w[1] + p["b_enc_pre"], dt)
    skips = [y]
    for i in range(n_enc):
        x_in = y
        y = _silu(_conv_k(y, p[f"w_enc{i}"], p[f"b_enc{i}"]), dt)
        skips.append(y)
        if resnet:
            y = y + x_in
    x_res = y
    # rf_pre: frequency resample (contracts F), then a 1x1 conv
    y = torch.einsum("bfc,fo->boc", y.float(), p["w_rf_pre_lin"]).to(dt)
    y = (y.float() @ p["w_rf_pre"] + p["b_rf_pre"]).to(dt)
    y, h_new = rnnformer_stack_reference(plan["stack"], y.contiguous(), h,
                                         num_heads)
    y = torch.einsum("bfc,fo->boc", y.float(), p["w_rf_post_lin"]).to(dt)
    y = (y.float() @ p["w_rf_post"] + p["b_rf_post"]).to(dt)
    if resnet:
        y = y + x_res
    for i in range(n_enc):
        x_in = y
        skip = skips.pop()
        z = _silu(y.float() @ p[f"w_dec{i}_x"] + skip.float() @ p[f"w_dec{i}_s"]
                  + p[f"b_dec{i}_1"], dt)
        y = _silu(_conv_k(z, p[f"w_dec{i}_2"], p[f"b_dec{i}_2"]), dt)
        if resnet:
            y = y + x_in
    skip = skips.pop()
    y = _silu(y.float() @ p["w_post_x"] + skip.float() @ p["w_post_s"]
              + p["b_post"], dt).float()
    zeros = y.new_zeros(b, 1, y.shape[-1])
    y_prev = torch.cat([zeros, y[:, :-1]], 1)               # x[m-1]
    y_next = torch.cat([y[:, 1:], zeros], 1)                # x[m+1]
    half = stride // 2
    phases = [y @ p["w_convt_a"][r]
              + (y_prev if r < half else y_next) @ p["w_convt_b"][r]
              for r in range(stride)]
    out = torch.cat(phases, -1) + p["b_convt"]              # [B, F_enc, 2s]
    if mask == "sigmoid":
        out = torch.sigmoid(out)
    elif mask == "tanh":
        out = torch.tanh(out)
    return out.to(dt), h_new


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def smem_bytes(n_enc: int, f_enc: int, channels: int, block_freq: int,
               block_channels: int, num_heads: int, stride: int) -> int:
    """Shared memory of one thread block (one stream) of the float32 form,
    as the kernel lays it out: the input frame, n_enc + 1 skips, two work
    buffers and the block stack's buffers, all float32. The bfloat16 form's
    comes from the kernel's library (`fused_frame_step`)."""
    fc = f_enc * channels
    work = max(fc, block_freq * channels, f_enc * block_channels)
    stack = (6 * block_freq * block_channels
             + num_heads * block_freq * block_freq)
    return 4 * ((f_enc + 1) * 2 * stride + (n_enc + 1) * fc + 2 * work
                + stack)


def _check(plan: Params, x: Tensor, h: Tensor, num_heads: int, n_enc: int,
           enc_ks: tp.Sequence[int], f_enc: int, block_freq: int,
           stride: int, mask: tp.Optional[str]) -> None:
    b = x.shape[0]
    if x.ndim != 3 or tuple(x.shape[1:]) != (f_enc + 1, 2 * stride):
        raise ValueError(f"x must be [B, {f_enc + 1}, {2 * stride}]; got "
                         f"{tuple(x.shape)}")
    if len(enc_ks) != n_enc or mask not in MASKS:
        raise ValueError(f"need {n_enc} encoder kernel sizes and a mask in "
                         f"{MASKS}; got {tuple(enc_ks)} and {mask!r}")
    cc = h.shape[-1]
    _check_stack(plan["stack"], x.new_empty(b, block_freq, cc), h,
                 num_heads)
    c = plan["b_enc_pre"].shape[0]
    shapes = {"w_enc_pre": (2, 2 * stride, c), "b_enc_pre": (c,),
              "w_rf_pre_lin": (f_enc, block_freq), "w_rf_pre": (c, cc),
              "b_rf_pre": (cc,), "w_rf_post_lin": (block_freq, f_enc),
              "w_rf_post": (cc, c), "b_rf_post": (c,),
              "w_post_x": (c, c), "w_post_s": (c, c), "b_post": (c,),
              "w_convt_a": (stride, c, 2), "w_convt_b": (stride, c, 2),
              "b_convt": (2 * stride,)}
    for i, k in enumerate(enc_ks):
        shapes.update({f"w_enc{i}": (k, c, c), f"b_enc{i}": (c,),
                       f"w_dec{i}_x": (c, c), f"w_dec{i}_s": (c, c),
                       f"b_dec{i}_1": (c,), f"b_dec{i}_2": (c,),
                       f"w_dec{i}_2": (enc_ks[n_enc - 1 - i], c, c)})
    for name in frame_plan_keys(n_enc):
        t = plan[name]
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every "
                             f"operand must be {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"plan[{name!r}] has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def fused_frame_step(plan: Params, x: Tensor, h: Tensor, *, num_blocks: int,
                     num_heads: int, n_enc: int, enc_ks: tp.Sequence[int],
                     f_enc: int, block_freq: int, stride: int, resnet: bool,
                     mask: tp.Optional[str]) -> tp.Tuple[Tensor, Tensor]:
    """One whole spec->mask frame.

    x: [B, F_enc+1, 2s] (the strided reshape of the compressed spec frame),
    h: [NB, B*F', C'] stacked GRU carries, rows batch-major -> (mask8
    [B, F_enc, 2s], phase-interleaved: reshape to [B, F_enc*s, 2]; h_new),
    fresh tensors. Every operand has x's dtype (float32 or bfloat16) and
    device and is contiguous. The op `torch.ops.fastenhancer.fused_frame`
    (ops/_library.py): on the CPU the plain version; on a CUDA device it
    launches the kernel (building it on first use) and raises if it
    cannot."""
    if h.ndim != 3 or h.shape[0] != num_blocks:
        raise ValueError(f"h must be [{num_blocks}, B*F', C']; got "
                         f"{tuple(h.shape)}")
    _check(plan, x, h, num_heads, n_enc, enc_ks, f_enc, block_freq, stride,
           mask)
    _build.check_device(x)
    return tuple(torch.ops.fastenhancer.fused_frame(
        [plan[k] for k in frame_plan_keys(n_enc)],
        [plan["stack"][k] for k in STACK_KEYS], x, h, num_heads,
        list(enc_ks), f_enc, block_freq, stride, resnet, mask))


def cpu_impl(frame: tp.List[Tensor], stack: tp.List[Tensor], x: Tensor,
             h: Tensor, num_heads: int, enc_ks: tp.List[int], f_enc: int,
             block_freq: int, stride: int, resnet: bool,
             mask: tp.Optional[str]) -> tp.Tuple[Tensor, Tensor]:
    """The op's CPU implementation: the plain version."""
    plan = dict(zip(frame_plan_keys(len(enc_ks)), frame))
    plan["stack"] = dict(zip(STACK_KEYS, stack))
    return fused_frame_reference(
        plan, x, h, num_heads=num_heads, n_enc=len(enc_ks), enc_ks=enc_ks,
        f_enc=f_enc, block_freq=block_freq, stride=stride, resnet=resnet,
        mask=mask)


def fake_impl(frame: tp.List[Tensor], stack: tp.List[Tensor], x: Tensor,
              h: Tensor, num_heads: int, enc_ks: tp.List[int], f_enc: int,
              block_freq: int, stride: int, resnet: bool,
              mask: tp.Optional[str]) -> tp.Tuple[Tensor, Tensor]:
    """The op's shapes and types: mask8 [B, F_enc, 2s] in x's dtype, h_new
    like h."""
    return (x.new_empty(x.shape[0], f_enc, 2 * stride),
            torch.empty_like(h))


def cuda_impl(frame: tp.List[Tensor], stack: tp.List[Tensor], x: Tensor,
              h: Tensor, num_heads: int, enc_ks: tp.List[int], f_enc: int,
              block_freq: int, stride: int, resnet: bool,
              mask: tp.Optional[str]) -> tp.Tuple[Tensor, Tensor]:
    """The op's CUDA implementation: one launch of the kernel, counted in
    fused_frame_step.launches."""
    fn = _build.entry("fused_frame", x.dtype, _ARGTYPES)
    n_enc = len(enc_ks)
    b = x.shape[0]
    c = frame[frame_plan_keys(n_enc).index("b_enc_pre")].shape[0]
    cc = h.shape[-1]
    dims = [b, f_enc, block_freq, c, cc, num_heads, h.shape[0], stride,
            n_enc, int(resnet), MASKS.index(mask), *enc_ks]
    c_dims = (ctypes.c_int * len(dims))(*dims)
    if x.dtype == torch.bfloat16:
        smem = _build.function(
            "fused_frame", "fused_frame_smem_bf16", ctypes.c_size_t,
            [ctypes.POINTER(ctypes.c_int), ctypes.c_int])(c_dims, len(dims))
    else:
        smem = smem_bytes(n_enc, f_enc, c, block_freq, cc, num_heads, stride)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"F_enc={f_enc}, C={c}, F'={block_freq}, C'={cc}, H={num_heads}, "
            f"{n_enc} encoder convs need {smem} bytes of shared memory per "
            f"stream; the kernel has {MAX_SMEM_BYTES}")
    mask8 = torch.empty(b, f_enc, 2 * stride, dtype=x.dtype, device=x.device)
    h_out = torch.empty_like(h)
    frame_ptrs = [t.data_ptr() for t in frame]
    stack_ptrs = [t.data_ptr() for t in stack]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), mask8.data_ptr(),
                 h_out.data_ptr(),
                 (ctypes.c_void_p * len(frame_ptrs))(*frame_ptrs),
                 len(frame_ptrs),
                 (ctypes.c_void_p * len(stack_ptrs))(*stack_ptrs),
                 c_dims, len(dims), stream)
    _build.check_launch("fused_frame", err)
    fused_frame_step.launches += 1
    return mask8, h_out


fused_frame_step.launches = 0
