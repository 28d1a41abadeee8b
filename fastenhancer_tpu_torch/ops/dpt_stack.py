"""The dptransformer block stack for one streaming frame: plan, plain
version and the wrapper of the hand-written CUDA kernel (csrc/dpt_stack.cu).

Replaces fastenhancer_tpu/ops/dpt_stack.py::dpt_stack_step (the Pallas TPU
kernel) for the folded block form. Per block: causal local time attention
of every (stream, frequency bin) row over the last L frames' keys and values
plus its own, with a learned relative-age bias time_pe [H, L+1]; time_fc
plus residual; the positional embedding; H-head frequency self-attention;
freq_fc plus residual.

The K/V cache is a rotating buffer of L slots per block: the frame's k and
v go into slot `ptr`, the slot of the oldest frame, after this frame has
attended to it, and the pointer advances mod L. Slot s was last written
((ptr - 1 - s) mod L) + 1 frames ago; that age picks its bias
time_pe[:, L - age], and the current frame takes time_pe[:, L]. A slot that
was never written holds zeros: it adds nothing to the value mix and its
exp(bias) mass to the softmax denominator, the same multiset of logits as
the unfused path's zero-initialised cache, so a stream's zeroed slots are
correct at any pointer value. That is what lets the serving engine reset
one stream's cache while the others keep their history and the shared
pointer.

Layout, chosen for the card rather than the TPU's channel-major lanes:
kc/vc are [NB, B, L, F, C], so one stream's slice of one block's cache is
one contiguous run of L*F*C values, and the batch axis stays one axis the
serving engine can infer. `ptr` is an int32 tensor of shape () on the
activations' device, read by the kernel, so no frame waits on the host.

* `plan_dpt_stack` packs folded rf_blocks params and the model's time_pe
  into stacked arrays, matrices [in, out].
* `dpt_stack_reference` is the plain PyTorch version of the kernel's math,
  with the same float32 accumulation and the same rounding points to the
  activation type. The CPU path uses it; the card's checks compare the
  kernel against it.
* `dpt_stack_step` is the wrapper: it checks the operands and calls the op
  `torch.ops.fastenhancer.dpt_stack` (ops/_library.py), whose CPU
  implementation is the plain version (`cpu_impl`) and whose CUDA one
  launches the kernel or raises (`cuda_impl`); nothing falls back. The
  kernel has two forms, chosen by shape alone before launch
  (`kernel_form`): the tensor-core form (csrc/dpt_tc.cuh, the cache
  streamed through a shared-memory ring by bulk copies) for bfloat16 when
  a slot's F*C*2 bytes are a multiple of 16 and its shared memory fits,
  else the scalar form (float32 always). `dpt_stack_step.launches` counts
  launches of either form, `.tc_launches` those of the tensor-core form,
  both in `cuda_impl`; `launch_scalar` and `launch_tc` launch one form
  directly and count nothing.

Both write the frame's k and v into slot `ptr` of kc and vc in place and
return the advanced pointer as a new tensor. What bounds the kernel on the
H100, and what its design does about it, is in the note at the top of
csrc/dpt_stack.cu.
"""
from __future__ import annotations

import ctypes
import math
import typing as tp

import torch

from . import _build

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]

PLAN_KEYS = ("w_tqkv", "b_tqkv", "w_tfc", "b_tfc", "w_fqkv", "b_fqkv",
             "w_ffc", "b_ffc", "pe", "time_pe")
MAX_SMEM_BYTES = _build.MAX_SMEM_BYTES
# x, kc, vc, ptr, x_out, ptr_out, the plan; B, F, C, H, NB, L; the stream
# (both forms)
_ARGTYPES = ([ctypes.c_void_p] * (6 + len(PLAN_KEYS)) + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
# the tensor-core form's cache ring (csrc/dpt_tc.cuh): chunks in flight a
# thread block, the most bytes of whole slots a chunk holds, and the head
# of its shared memory (zero chunk and mbarriers), in bytes
TC_RING = 4
TC_CHUNK_BYTES = 16384
TC_HEAD_BYTES = 2 * _build.round8(8 + 4 * TC_RING)
# the widest head whose q a thread holds in registers, the most rows
# (heads x bins) the attention gives one thread each, and the largest frame
# (F x C) whose value mix the threads hold in registers (4 channel pairs
# each)
TC_MAX_HEAD_DIM = 16
TC_MAX_ROWS = 256
TC_MAX_FRAME = 2048


# ---------------------------------------------------------------------------
# Plan: folded block params -> stacked kernel-ready arrays
# ---------------------------------------------------------------------------

def plan_dpt_stack(blocks: tp.Sequence[Params], time_pe: Tensor, freq: int,
                   num_heads: int, dtype: tp.Optional[torch.dtype] = None
                   ) -> Params:
    """Pack folded dpt rf_blocks params (Model.fold() output: weight norm
    stripped, post-norms merged into the fcs, pre-norms into the qkv) and
    the model-level relative time bias time_pe [H, L+1] into stacked arrays
    with the block index leading; matrices are [in, out]. dtype=None keeps
    the blocks' own dtype.

    The reference qkv weight rows are per head [q_h | k_h | v_h]; they are
    gathered so that output column h*d + t of w_*qkv[:, 0/1/2] is head h,
    dim t of q/k/v. pe is zero for blocks without a positional embedding
    (only block 0 has one)."""
    w0 = blocks[0]["time_attn"]["qkv"]["weight"]
    if isinstance(w0, dict):
        raise ValueError("plan_dpt_stack expects fold() output "
                         "(weight norm still present)")
    dtype = w0.dtype if dtype is None else dtype
    device = w0.device
    c = w0.shape[1]
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by heads {num_heads}")
    d = c // num_heads
    lane = torch.arange(c, device=device)
    q_rows = (lane // d) * 3 * d + lane % d
    zeros = torch.zeros(3 * c, dtype=w0.dtype, device=device)

    def qkv(b: Params, which: str) -> tp.Tuple[Tensor, Tensor]:
        p = b[f"{which}_attn"]["qkv"]
        bias = p.get("bias", zeros)
        return (torch.stack([p["weight"][q_rows + o * d].T for o in range(3)]),
                torch.stack([bias[q_rows + o * d] for o in range(3)]))

    def one(b: Params) -> Params:
        (w_t, b_t), (w_f, b_f) = qkv(b, "time"), qkv(b, "freq")
        pe = b.get("pe")
        return {
            "w_tqkv": w_t, "b_tqkv": b_t,
            "w_tfc": b["time_fc"]["weight"].T,
            "b_tfc": b["time_fc"].get("bias", zeros[:c]),
            "w_fqkv": w_f, "b_fqkv": b_f,
            "w_ffc": b["freq_fc"]["weight"].T,
            "b_ffc": b["freq_fc"].get("bias", zeros[:c]),
            "pe": (pe["weight"] if pe is not None
                   else torch.zeros(freq, c, dtype=w0.dtype, device=device)),
        }

    per_block = [one(b) for b in blocks]
    plan = {k: torch.stack([p[k] for p in per_block])
            for k in PLAN_KEYS if k != "time_pe"}
    plan["time_pe"] = time_pe
    return {k: v.to(dtype).contiguous() for k, v in plan.items()}


def plan_shapes(num_blocks: int, freq: int, channels: int, num_heads: int,
                lookbehind: int) -> tp.Dict[str, tp.Tuple[int, ...]]:
    """Shape of each plan array, as `plan_dpt_stack` makes it and the
    kernel reads it."""
    nb, f, c = num_blocks, freq, channels
    return {"w_tqkv": (nb, 3, c, c), "b_tqkv": (nb, 3, c),
            "w_tfc": (nb, c, c), "b_tfc": (nb, c),
            "w_fqkv": (nb, 3, c, c), "b_fqkv": (nb, 3, c),
            "w_ffc": (nb, c, c), "b_ffc": (nb, c), "pe": (nb, f, c),
            "time_pe": (num_heads, lookbehind + 1)}


def cache_shape(num_blocks: int, batch: int, lookbehind: int, freq: int,
                channels: int) -> tp.Tuple[int, ...]:
    """Shape of the rotating K (and V) cache: [NB, B, L, F, C]."""
    return (num_blocks, batch, lookbehind, freq, channels)


def slot_bias(time_pe: Tensor, ptr: Tensor) -> Tensor:
    """[H, L+1] float32 bias of every key this frame: slot s < L was written
    ((ptr - 1 - s) mod L) + 1 frames ago and takes time_pe[:, L - age]; the
    current frame (index L) takes time_pe[:, L]. ptr stays on its device."""
    lb = time_pe.shape[1] - 1
    s = torch.arange(lb, device=time_pe.device)
    age = torch.remainder(ptr.to(time_pe.device).long() - 1 - s, lb) + 1
    idx = torch.cat([lb - age, s.new_full((1,), lb)])
    return time_pe.float().index_select(1, idx)


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel's math
# ---------------------------------------------------------------------------

def dpt_stack_reference(plan: Params, x: Tensor, kc: Tensor, vc: Tensor,
                        ptr: Tensor, num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """x: [B, F, C], kc/vc: [NB, B, L, F, C], ptr: int32 [] (taken mod L)
    -> (x_out [B, F, C], (ptr + 1) mod L); writes this frame's k and v into
    slot ptr of kc and vc in place.

    float32 accumulation and softmax math; results rounded to x.dtype where
    the kernel rounds them: q/k/v, the q*k products of the time attention
    (as the Pallas kernel's elementwise product in the activation type),
    the probabilities, each attention output, fc outputs and residual sums.
    Both softmaxes use each (row, head)'s own max."""
    b, f, c = x.shape
    nb, _, lb = kc.shape[:3]
    dt = x.dtype
    h = num_heads
    d = c // h
    scale = 1.0 / math.sqrt(d)
    p = {k: v.float() for k, v in plan.items()}
    ptr = torch.remainder(ptr, lb)
    bias = slot_bias(plan["time_pe"], ptr)                     # [H, L+1]
    xs = x.reshape(b * f, c)
    for i in range(nb):
        # --- causal local time attention over the L slots + this frame ---
        xf = xs.float()
        q, k, v = [(xf @ p["w_tqkv"][i, o] + p["b_tqkv"][i, o]).to(dt)
                   for o in range(3)]
        qh = q.reshape(b, 1, f, h, d)
        kh = torch.cat([kc[i], k.reshape(b, 1, f, c)], 1).reshape(
            b, lb + 1, f, h, d)
        logits = (qh * kh).float().sum(-1) * scale             # [B, S, F, H]
        logits = logits + bias.T[None, :, None, :]
        probs = torch.softmax(logits, dim=1).to(dt).float()
        vv = torch.cat([vc[i], v.reshape(b, 1, f, c)], 1).float()
        attn = (probs.repeat_interleave(d, dim=-1) * vv).sum(1)  # [B, F, C]
        attn = attn.reshape(b * f, c).to(dt)
        kc[i].index_copy_(1, ptr.to(kc.device).long().view(1),
                          k.reshape(b, 1, f, c))
        vc[i].index_copy_(1, ptr.to(vc.device).long().view(1),
                          v.reshape(b, 1, f, c))
        y = (attn.float() @ p["w_tfc"][i] + p["b_tfc"][i]).to(dt)
        xs = y + xs
        xs = (xs.reshape(b, f, c) + plan["pe"][i]).reshape(b * f, c)
        # --- frequency MHSA, freq_fc + residual ---
        xf = xs.float()
        q, k, v = [(xf @ p["w_fqkv"][i, o] + p["b_fqkv"][i, o]).to(dt)
                   for o in range(3)]
        q, k, v = [t.float().reshape(b, f, h, d) for t in (q, k, v)]
        logits = torch.einsum("bfhd,bghd->bhfg", q, k) * scale
        probs = torch.softmax(logits, dim=-1).to(dt).float()
        attn = torch.einsum("bhfg,bghd->bfhd", probs, v).reshape(b * f, c)
        y = (attn.to(dt).float() @ p["w_ffc"][i] + p["b_ffc"][i]).to(dt)
        xs = y + xs
    return xs.reshape(b, f, c), torch.remainder(ptr + 1, lb)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def smem_bytes(freq: int, channels: int, num_heads: int,
               lookbehind: int) -> int:
    """Shared memory of one thread block (one stream): four [F, C] float32
    buffers and the [H, F, max(F, L+1)] logits."""
    return 4 * (4 * freq * channels
                + num_heads * freq * max(freq, lookbehind + 1))


def tc_chunk_slots(freq: int, channels: int, lookbehind: int) -> int:
    """Cache slots in one chunk of the tensor-core form's ring: as many
    whole [F, C] slots as fit TC_CHUNK_BYTES, at least 1, at most L."""
    return min(max(TC_CHUNK_BYTES // (2 * freq * channels), 1), lookbehind)


def tc_smem_bytes(freq: int, channels: int, num_heads: int,
                  lookbehind: int) -> int:
    """Shared memory of one thread block of the tensor-core form, as
    dpt_tc.cuh's DptGeom counts it: the head, the block stack's bf16 tiles
    (x, two free tiles, head-padded q, k, v, the frequency probabilities),
    the float32 logits [L+1, ldr] (ldr: H F rounded up to 8 mod 32) and
    [H, L+1] slot bias, the cache ring and two weight slots (q, k, v or
    time_fc with pe, rows padded)."""
    f, c, h, keys = freq, channels, num_heads, lookbehind + 1
    ld, r8 = _build.ld_of, _build.round8
    dp = (c // h + 15) // 16 * 16
    tiles = 3 * f * ld(c) + 3 * f * ld(h * dp) + h * f * ld(f)
    ldr = h * f + (40 - h * f % 32) % 32
    floats = -(-keys * ldr // 4) * 4 + -(-h * keys // 4) * 4
    ring = TC_RING * tc_chunk_slots(f, c, lookbehind) * f * c
    slot = max(3 * c * ld(c) + r8(3 * c), c * ld(c) + r8(c) + r8(f * c))
    return TC_HEAD_BYTES + 2 * (tiles + 2 * floats + ring + 2 * slot)


def kernel_form(freq: int, channels: int, num_heads: int, lookbehind: int,
                dtype: torch.dtype) -> str:
    """Which form of the kernel runs, by shape alone, before launch: "tc"
    (csrc/dpt_tc.cuh) for bfloat16 when a cache slot's F*C*2 bytes are a
    multiple of 16 (the bulk copy's unit), C / H <= 16, H * F <= 256,
    F * C <= 2048 and its shared memory fits; else "scalar" (the
    float32-FMA form, which float32 always takes)."""
    if (dtype == torch.bfloat16 and (2 * freq * channels) % 16 == 0
            and channels // num_heads <= TC_MAX_HEAD_DIM
            and num_heads * freq <= TC_MAX_ROWS
            and freq * channels <= TC_MAX_FRAME
            and tc_smem_bytes(freq, channels, num_heads, lookbehind)
            <= MAX_SMEM_BYTES):
        return "tc"
    return "scalar"


def _check(plan: Params, x: Tensor, kc: Tensor, vc: Tensor, ptr: Tensor,
           num_heads: int) -> None:
    if x.ndim != 3 or kc.ndim != 5:
        raise ValueError(f"x must be [B, F, C] and kc [NB, B, L, F, C]; got "
                         f"{tuple(x.shape)} and {tuple(kc.shape)}")
    b, f, c = x.shape
    nb, _, lb = kc.shape[:3]
    if b == 0 or lb == 0 or c % num_heads:
        raise ValueError(f"need B >= 1, L >= 1 and C % H == 0; got B={b}, "
                         f"L={lb}, C={c}, H={num_heads}")
    want = cache_shape(nb, b, lb, f, c)
    for name, t in (("kc", kc), ("vc", vc)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")
    if ptr.shape != () or ptr.dtype != torch.int32 or ptr.device != x.device:
        raise ValueError(f"ptr must be an int32 tensor of shape () on "
                         f"{x.device}; got {ptr.dtype} {tuple(ptr.shape)} on "
                         f"{ptr.device}")
    shapes = plan_shapes(nb, f, c, num_heads, lb)
    for name, t in (("x", x), ("kc", kc), ("vc", vc),
                    *((k, plan[k]) for k in PLAN_KEYS)):
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


def _launch(fn: tp.Callable[..., int], plan: Params, x: Tensor, kc: Tensor,
            vc: Tensor, ptr: Tensor, num_heads: int
            ) -> tp.Tuple[Tensor, Tensor]:
    b, f, c = x.shape
    nb, _, lb = kc.shape[:3]
    x_out = torch.empty_like(x)
    ptr_out = torch.empty_like(ptr)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), kc.data_ptr(), vc.data_ptr(), ptr.data_ptr(),
                 x_out.data_ptr(), ptr_out.data_ptr(),
                 *(plan[k].data_ptr() for k in PLAN_KEYS),
                 b, f, c, num_heads, nb, lb, stream)
    _build.check_launch("dpt_stack", err)
    return x_out, ptr_out


def launch_scalar(plan: Params, x: Tensor, kc: Tensor, vc: Tensor,
                  ptr: Tensor, num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """Launch the scalar form (one thread block per stream) on CUDA tensors
    that passed _check; counts nothing."""
    _cuda_only(x)
    _, f, c = x.shape
    lb = kc.shape[2]
    smem = smem_bytes(f, c, num_heads, lb)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"F={f}, C={c}, H={num_heads}, L={lb} needs {smem} bytes of "
            f"shared memory per stream; the kernel has {MAX_SMEM_BYTES}")
    return _launch(_build.entry("dpt_stack", x.dtype, _ARGTYPES), plan, x,
                   kc, vc, ptr, num_heads)


def launch_tc(plan: Params, x: Tensor, kc: Tensor, vc: Tensor, ptr: Tensor,
              num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """Launch the tensor-core form on bfloat16 CUDA tensors that passed
    _check and whose shape kernel_form gives to it, with kc and vc 16-byte
    aligned (the ring's bulk copies read them); counts nothing."""
    _, f, c = x.shape
    lb = kc.shape[2]
    if kernel_form(f, c, num_heads, lb, x.dtype) != "tc":
        raise ValueError(f"the tensor-core form does not take F={f}, C={c}, "
                         f"H={num_heads}, L={lb} in {x.dtype} (see "
                         "kernel_form)")
    for name, t in (("kc", kc), ("vc", vc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             "tensor-core form")
    _cuda_only(x)
    return _launch(_build.function("dpt_stack", "dpt_stack_tc_bf16",
                                   ctypes.c_int, _ARGTYPES),
                   plan, x, kc, vc, ptr, num_heads)


def dpt_stack_step(plan: Params, x: Tensor, kc: Tensor, vc: Tensor,
                   ptr: Tensor, num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """One streaming frame through every dpt block.

    x: [B, F, C] frame activations (rf_pre output); kc/vc: [NB, B, L, F, C]
    rotating K/V caches; ptr: int32 [] slot pointer on x's device ->
    (x_out [B, F, C], the advanced pointer (ptr + 1) mod L), both fresh
    tensors. The frame's k and v are written into slot ptr of kc and vc in
    place. Every float operand has x's dtype (float32 or bfloat16) and
    device and is contiguous. The op `torch.ops.fastenhancer.dpt_stack`
    (ops/_library.py; kc and vc are declared mutated): on the CPU the
    plain version; on a CUDA device it launches the form `kernel_form`
    picks (building the kernel on first use) and raises if it cannot."""
    _check(plan, x, kc, vc, ptr, num_heads)
    _build.check_device(x)
    return tuple(torch.ops.fastenhancer.dpt_stack(
        [plan[k] for k in PLAN_KEYS], x, kc, vc, ptr, num_heads))


def cpu_impl(plan: tp.List[Tensor], x: Tensor, kc: Tensor, vc: Tensor,
             ptr: Tensor, num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """The op's CPU implementation: the plain version."""
    return dpt_stack_reference(dict(zip(PLAN_KEYS, plan)), x, kc, vc, ptr,
                               num_heads)


def fake_impl(plan: tp.List[Tensor], x: Tensor, kc: Tensor, vc: Tensor,
              ptr: Tensor, num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """The op's shapes and types: x_out like x, the pointer like ptr."""
    return torch.empty_like(x), torch.empty_like(ptr)


def cuda_impl(plan: tp.List[Tensor], x: Tensor, kc: Tensor, vc: Tensor,
              ptr: Tensor, num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """The op's CUDA implementation: one launch of the form kernel_form
    picks, counted in dpt_stack_step.launches (and .tc_launches)."""
    plan = dict(zip(PLAN_KEYS, plan))
    _, f, c = x.shape
    if kernel_form(f, c, num_heads, kc.shape[2], x.dtype) == "tc":
        out = launch_tc(plan, x, kc, vc, ptr, num_heads)
        dpt_stack_step.tc_launches += 1
    else:
        out = launch_scalar(plan, x, kc, vc, ptr, num_heads)
    dpt_stack_step.launches += 1
    return out


dpt_stack_step.launches = 0
dpt_stack_step.tc_launches = 0
