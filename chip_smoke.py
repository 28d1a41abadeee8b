"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It drives the streaming paths of `fastenhancer_tpu_torch` (no JAX anywhere)
through the hand-written CUDA kernels, in eleven phases, each printed on
its own line:

  1. card: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for the float32 checks;
  2. build: every kernel compiled from this checkout with nvcc, one nvcc
     process per source, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card in
     float32 and bfloat16 (the block stack and the whole frame at the
     FastEnhancer T/B/S shapes, the dpt stack at the DPT T/B/S block shapes
     with a wrapped pointer and unwritten cache slots, the BSRNN stack at
     the BSRNN-XT and -S shapes, the dprnn stack at the DPRNN-T and -B
     shapes), and each timed with CUDA events at B=256 bfloat16 beside its
     plain version and its bound;
  4. serving FE_B: a StreamingEngine (capacity 256, bfloat16, fused)
     answers a few staggered requests; outputs are checked for length,
     finiteness, agreement with an isolated run, and the stack kernel's
     launch count; the unfused float32 path is checked against the fused
     one;
  5. throughput FE_B: Model.stream over 256 streams in bfloat16, reported
     as per-stream RTF = wall / (audio seconds x streams);
  6. serving DPT-B: the same for the dptransformer model through the dpt
     stack kernel, a slot reused while the shared slot pointer moves on;
  7. whole frame FE_B: streaming_step_fused_frame (one kernel per frame for
     the whole spec->mask model) over 256 streams, against
     streaming_step_fused on the same input, both timed per frame;
  8. throughput DPT-B: Model.stream(fused_plan=...) over 256 streams;
  9. serving BSRNN-S, as phase 4, through the BSRNN stack kernel;
 10. serving DPRNN-B, as phase 4, through the dprnn stack kernel;
 11. throughput BSRNN-S: Model.stream(fused_plan=...) over 256 streams.

Each of phases 4 to 11 drives a path: every kernel's launch count is set to
0 just before it and read just after, and the path fails unless its own
kernel ran once per frame and no other kernel ran. The line before the
last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure raises
and exits non-zero, and so does a machine without a CUDA device.
"""
import json
import os
import statistics
import subprocess
import sys
import time

F32_TOL = 1e-5      # absolute, kernel vs plain, float32
BF16_REL = 2 ** -5  # bfloat16: of the largest magnitude (a few bf16 ulps)
STREAM_F32_TOL = 1e-4  # float32 stream outputs, fused vs unfused
SR = 16_000
STREAMS = 256
FE_SECONDS = 10.0      # phase 5's audio per stream
FRAME_SECONDS = 5.0    # phase 7's audio per stream
DPT_SECONDS = 5.0      # phase 8's audio per stream
BSRNN_SECONDS = 5.0    # phase 11's audio per stream
# the H100 SXM's published peaks (NVIDIA H100 datasheet)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fastenhancer_tpu_torch import require_cuda
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.ops import _build
    from fastenhancer_tpu_torch.ops import bsrnn_stack as band
    from fastenhancer_tpu_torch.ops import dprnn_stack as dprnn
    from fastenhancer_tpu_torch.ops import dpt_stack as dpt
    from fastenhancer_tpu_torch.ops import fused_frame as frame
    from fastenhancer_tpu_torch.ops import rnnformer_stack as stack
    from fastenhancer_tpu_torch.presets import BSRNN_S, DPRNN_B, DPT_B, FE_B
    from fastenhancer_tpu_torch.serving import StreamingEngine
    from fastenhancer_tpu_torch.utils import cast_floating

    dev = require_cuda()
    wrappers = {"rnnformer_stack_step": stack.rnnformer_stack_step,
                "fused_frame_step": frame.fused_frame_step,
                "dpt_stack_step": dpt.dpt_stack_step,
                "bsrnn_stack_step": band.bsrnn_stack_step,
                "dprnn_stack_step": dprnn.dprnn_stack_step}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def check_launches(counts, name, n, what):
        """The path's own kernel ran n times and no other kernel ran."""
        want = {k: (n if k == name else 0) for k in wrappers}
        _check(counts == want, f"{what}: launches {counts} != {want}")

    # -- 1. card -----------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    card = f"[{smi}]"
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1/11] card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} "
          f"| torch {torch.__version__}, CUDA {torch.version.cuda} | TF32 off "
          "for matmul and cuDNN (float32 checks run in full float32)")

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    names = _build.SOURCES
    _build.build_all(names, verbose=True)
    print(f"[2/11] build: {', '.join(n + '.cu' for n in names)} with nvcc for "
          f"sm_90a, in parallel, in {time.perf_counter() - t0:.2f} s")

    # -- 3. kernels against their plain versions ------------------------------------
    def time_ms(fn, reps=7, inner=20):
        """(device ms, host ms) per call. Device: the median over `reps` of
        CUDA-event time over `inner` back-to-back calls, with a sleep
        kernel queued first that outlasts the host's enqueueing of the
        calls, so the events time the card and not the host's dispatch.
        Host: wall time per call of the same calls run unqueued, which is
        what a caller waits for when the host is the slower side."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        cycles = int(4e9 * host_s)  # twice the enqueue time at <= 2 GHz
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times), 1e3 * host_s / inner

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def bound(flops, n_bytes, dtype):
        """The least time the card could take: the larger of the bytes over
        the memory rate and the operations over the type's peak."""
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        return dict(bound_ms=max(t_ops, t_bytes), flops=flops, bytes=n_bytes,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")

    def compare(name, pairs, dtype):
        """Max abs error of each (kernel, plain) pair against its
        tolerance; raises on any above it."""
        errs = []
        for got, want in pairs:
            want = want.float()
            err = (got.float() - want).abs().max().item()
            tol = (F32_TOL if dtype == torch.float32
                   else BF16_REL * want.abs().max().item())
            _check(err <= tol, f"{name} {dtype}: kernel vs plain max abs "
                               f"err {err:.3e} > {tol:.3e}")
            errs.append((err, tol))
        return errs

    def graphed(fn):
        """fn captured as one CUDA graph: its replay is one launch for the
        host, so the sleep kernel can keep the queue ahead of a plain
        version of thousands of launches."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph.replay

    def timed(kernel, plain, err, bound_info, plain_graph=False):
        ms, host_ms = time_ms(kernel)
        if plain_graph:
            # thousands of launches per call: the device time of the plain
            # version is timed as a CUDA graph's replay, the host time as
            # its eager calls
            plain_ms, _ = time_ms(graphed(plain), inner=4)
            _, plain_host_ms = time_ms(plain, reps=1, inner=1)
        else:
            # few calls: ~130 launches each must fit the card's launch
            # queue while the sleep kernel holds it
            plain_ms, plain_host_ms = time_ms(plain, inner=4)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    host_ms=host_ms, plain_host_ms=plain_host_ms,
                    plain_timing="as a CUDA graph" if plain_graph
                    else "eagerly", **bound_info)

    def uniform_plan(shapes, c, dtype, g):
        return {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(
            dev, dtype) for k, s in shapes.items()}

    def stack_flops(b, f, c, nb):
        # operations per row and block: GRU 6 CxC, rnn_fc, qkv 3, attn_fc
        # (11 C^2 multiply-adds) and the scores and mix (2 F C of them)
        return b * f * nb * (22 * c * c + 4 * f * c)

    heads = 4
    record = {}
    fe_t = dict(FE_B, channels=24, rnnformer_kwargs=dict(
        FE_B["rnnformer_kwargs"], num_blocks=2, channels=20, freq=16))
    fe_s = dict(FE_B, channels=64, kernel_size=[8, 3, 3, 3],
                rnnformer_kwargs=dict(FE_B["rnnformer_kwargs"], channels=48,
                                      freq=36))

    # 3a. the block stack (kernel 1)
    for name, (b, f, c, nb) in (("FE_B", (STREAMS, 24, 36, 3)),
                                ("FE_T", (STREAMS, 16, 20, 2)),
                                ("FE_S", (STREAMS, 36, 48, 3))):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(f * c)
            plan = uniform_plan(stack.plan_shapes(nb, f, c), c, dtype, g)
            x = torch.randn(b, f, c, generator=g).to(dev, dtype)
            h = (torch.randn(nb, b * f, c, generator=g) * 0.5).to(dev, dtype)
            xo, ho = stack.rnnformer_stack_step(plan, x, h, heads)
            torch.cuda.synchronize()
            xr, hr = stack.rnnformer_stack_reference(plan, x, h, heads)
            errs = compare(f"rnnformer_stack {name}", ((xo, xr), (ho, hr)),
                           dtype)
            print(f"[3/11] kernel rnnformer_stack {name} B={b} F={f} C={c} "
                  f"H={heads} NB={nb} {str(dtype)[6:]}: max abs err x_out "
                  f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_new "
                  f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
            if name == "FE_B" and dtype == torch.bfloat16:
                bound_info = bound(stack_flops(b, f, c, nb),
                                     nbytes(x, h, xo, ho, *plan.values()),
                                     dtype)
                record["rnnformer_stack_step"] = timed(
                    lambda: stack.rnnformer_stack_step(plan, x, h, heads),
                    lambda: stack.rnnformer_stack_reference(plan, x, h,
                                                            heads),
                    max(errs[0][0], errs[1][0]), bound_info)

    # 3b. the whole frame (kernel 7), on folded random-init models
    def frame_case(kwargs, b, dtype, seed):
        model = get_model("fastenhancer.default", **kwargs)
        folded = model.fold(model.init(torch.Generator().manual_seed(seed),
                                       dev))
        plan = model.build_frame_plan(folded, dtype=dtype)
        g = torch.Generator().manual_seed(seed + 1)
        x = torch.randn(b, model.freq + 1, 2 * model.stride, generator=g)
        h = torch.randn(model.num_blocks, b * model.block_freq,
                        model.block_channels, generator=g) * 0.5
        kw = dict(num_heads=model.rf.num_heads,
                  n_enc=len(model.kernel_size) - 1,
                  enc_ks=tuple(model.kernel_size[1:]), f_enc=model.freq,
                  block_freq=model.block_freq, stride=model.stride,
                  resnet=model.resnet, mask=model.mask_name)
        return model, plan, x.to(dev, dtype), h.to(dev, dtype), kw

    def frame_flops(model, b):
        fe_, c, s2 = model.freq, model.channels, 2 * model.stride
        f2, c2 = model.block_freq, model.block_channels
        ks = model.kernel_size[1:]
        per = (fe_ * c * 2 * s2                        # PreNet, 2 taps
               + sum(fe_ * c * k * c for k in ks)      # encoder convs
               + f2 * c * fe_ + f2 * c2 * c            # rf_pre
               + fe_ * c2 * f2 + fe_ * c * c2          # rf_post
               + sum(fe_ * c * 2 * c + fe_ * c * k * c for k in ks)  # dec
               + fe_ * c * 2 * c                       # dec_post
               + fe_ * s2 * 2 * c)                     # ConvTranspose
        return 2 * b * per + stack_flops(b, f2, c2, model.num_blocks)

    for name, kwargs in (("FE_B", FE_B), ("FE_T", fe_t), ("FE_S", fe_s)):
        for dtype in (torch.float32, torch.bfloat16):
            model, plan, x, h, kw = frame_case(kwargs, STREAMS, dtype, 3)
            mo, ho = frame.fused_frame_step(plan, x, h,
                                            num_blocks=model.num_blocks, **kw)
            torch.cuda.synchronize()
            mr, hr = frame.fused_frame_reference(plan, x, h, **kw)
            errs = compare(f"fused_frame {name}", ((mo, mr), (ho, hr)), dtype)
            print(f"[3/11] kernel fused_frame {name} B={STREAMS} F_enc="
                  f"{model.freq} C={model.channels} F'={model.block_freq} "
                  f"C'={model.block_channels} NB={model.num_blocks} "
                  f"{str(dtype)[6:]}: max abs err mask8 {errs[0][0]:.3e} "
                  f"(tol {errs[0][1]:.3e}), h_new {errs[1][0]:.3e} (tol "
                  f"{errs[1][1]:.3e})")
            if name == "FE_B" and dtype == torch.bfloat16:
                flat = [plan[k] for k in frame.frame_plan_keys(kw["n_enc"])]
                bound_info = bound(
                    frame_flops(model, STREAMS),
                    nbytes(x, h, mo, ho, *flat, *plan["stack"].values()),
                    dtype)
                record["fused_frame_step"] = timed(
                    lambda: frame.fused_frame_step(
                        plan, x, h, num_blocks=model.num_blocks, **kw),
                    lambda: frame.fused_frame_reference(plan, x, h, **kw),
                    max(errs[0][0], errs[1][0]), bound_info)

    # 3c. the dpt stack (kernel 2): a wrapped pointer, unwritten slots
    def dpt_flops(b, f, c, nb, lb):
        # multiply-adds per row and block: time qkv 3, time_fc, freq qkv 3,
        # freq_fc (8 C^2), the time scores and mix over L+1 keys and the
        # freq scores and mix over F keys
        return 2 * b * f * nb * (8 * c * c + 2 * (lb + 1) * c + 2 * f * c)

    lb = DPT_B["dpt_kwargs"]["lookbehind"]
    for name, (f, c, nb), (ptr, written) in (
            ("DPT_B", (24, 36, 3), (lb - 1, lb)),   # about to wrap
            ("DPT_T", (16, 20, 2), (0, lb)),        # wrapped to 0
            ("DPT_S", (36, 48, 3), (5, 12))):       # slots 12.. unwritten
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(f * c + 1)
            plan = uniform_plan(dpt.plan_shapes(nb, f, c, heads, lb), c,
                                dtype, g)
            x = torch.randn(STREAMS, f, c, generator=g).to(dev, dtype)
            shape = dpt.cache_shape(nb, STREAMS, lb, f, c)
            kc = torch.randn(shape, generator=g) * 0.5
            vc = torch.randn(shape, generator=g) * 0.5
            kc[:, :, written:] = 0
            vc[:, :, written:] = 0
            kc, vc = kc.to(dev, dtype), vc.to(dev, dtype)
            p = torch.tensor(ptr, dtype=torch.int32, device=dev)
            kc_r, vc_r = kc.clone(), vc.clone()
            xo, po = dpt.dpt_stack_step(plan, x, kc, vc, p, heads)
            torch.cuda.synchronize()
            xr, pr = dpt.dpt_stack_reference(plan, x, kc_r, vc_r, p, heads)
            _check(int(po) == int(pr) == (ptr + 1) % lb,
                   f"dpt_stack pointer {int(po)} / {int(pr)}")
            errs = compare(f"dpt_stack {name}",
                           ((xo, xr), (kc, kc_r), (vc, vc_r)), dtype)
            print(f"[3/11] kernel dpt_stack {name} B={STREAMS} F={f} C={c} "
                  f"H={heads} NB={nb} L={lb} ptr={ptr} written slots "
                  f"{written} {str(dtype)[6:]}: max abs err x_out "
                  f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), k cache "
                  f"{errs[1][0]:.3e}, v cache {errs[2][0]:.3e}")
            if name == "DPT_B" and dtype == torch.bfloat16:
                # bytes: the whole cache read once, one slot per block and
                # cache written, the frame in and out, the plan
                slot = kc[:, :, 0]
                bound_info = bound(
                    dpt_flops(STREAMS, f, c, nb, lb),
                    nbytes(x, kc, vc, xo, slot, slot, *plan.values()), dtype)
                record["dpt_stack_step"] = timed(
                    lambda: dpt.dpt_stack_step(plan, x, kc, vc, p, heads),
                    lambda: dpt.dpt_stack_reference(plan, x, kc_r, vc_r, p,
                                                    heads),
                    max(e for e, _ in errs), bound_info)
    # 3d. the BSRNN stack (kernel 3) at the XT and S shapes, 256 streams
    def band_flops(b, f, c, nl):
        # multiply-adds per row and layer with H = 2C: the time cell and
        # both sweep directions 4H (C + H) each, fc_time H C, fc_freq 2H C
        hd = 2 * c
        return 2 * b * f * nl * (3 * 4 * hd * (c + hd) + 3 * hd * c)

    for name, c in (("BSRNN_S", 64), ("BSRNN_XT", 16)):
        nl, f, hd = 6, 31, 2 * c
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(c + 3)
            plan = uniform_plan(band.plan_shapes(nl, c, hd), c, dtype, g)
            x = torch.randn(f, STREAMS, c, generator=g).to(dev, dtype)
            h = (torch.randn(nl, 2, f, STREAMS, hd, generator=g) * 0.5).to(
                dev, dtype)
            xo, ho = band.bsrnn_stack_step(plan, x, h)
            torch.cuda.synchronize()
            xr, hr = band.bsrnn_stack_reference(plan, x, h)
            errs = compare(f"bsrnn_stack {name}", ((xo, xr), (ho, hr)), dtype)
            print(f"[3/11] kernel bsrnn_stack {name} B={STREAMS} F={f} C={c} "
                  f"H={hd} L={nl} {str(dtype)[6:]}: max abs err x_out "
                  f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_new "
                  f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
            if name == "BSRNN_S" and dtype == torch.bfloat16:
                bound_info = bound(band_flops(STREAMS, f, c, nl),
                                   nbytes(x, h, xo, ho, *plan.values()),
                                   dtype)
                record["bsrnn_stack_step"] = timed(
                    lambda: band.bsrnn_stack_step(plan, x, h),
                    lambda: band.bsrnn_stack_reference(plan, x, h),
                    max(errs[0][0], errs[1][0]), bound_info, plain_graph=True)

    # 3e. the dprnn stack (kernel 6) at the DPRNN-T and -B shapes
    def dprnn_flops(b, f, c, hd, nb):
        # multiply-adds per row and block: the time GRU 6 C^2, trnn_fc C^2,
        # both sweep directions 3Hd (C + Hd) each, frnn_fc 2Hd C
        return 2 * b * f * nb * (7 * c * c + 6 * hd * (c + hd) + 2 * hd * c)

    for name, (f, c, nb) in (("DPRNN_B", (24, 36, 3)),
                             ("DPRNN_T", (16, 20, 2))):
        hd = c // 2
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(f * c + 2)
            plan = uniform_plan(dprnn.plan_shapes(nb, c, hd), c, dtype, g)
            x = torch.randn(f, STREAMS, c, generator=g).to(dev, dtype)
            h = (torch.randn(nb, f, STREAMS, c, generator=g) * 0.5).to(
                dev, dtype)
            xo, ho = dprnn.dprnn_stack_step(plan, x, h)
            torch.cuda.synchronize()
            xr, hr = dprnn.dprnn_stack_reference(plan, x, h)
            errs = compare(f"dprnn_stack {name}", ((xo, xr), (ho, hr)), dtype)
            print(f"[3/11] kernel dprnn_stack {name} B={STREAMS} F={f} C={c} "
                  f"Hd={hd} NB={nb} {str(dtype)[6:]}: max abs err x_out "
                  f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_new "
                  f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
            if name == "DPRNN_B" and dtype == torch.bfloat16:
                bound_info = bound(dprnn_flops(STREAMS, f, c, hd, nb),
                                   nbytes(x, h, xo, ho, *plan.values()),
                                   dtype)
                record["dprnn_stack_step"] = timed(
                    lambda: dprnn.dprnn_stack_step(plan, x, h),
                    lambda: dprnn.dprnn_stack_reference(plan, x, h),
                    max(errs[0][0], errs[1][0]), bound_info, plain_graph=True)

    for name, r in record.items():
        print(f"[3/11] time {name} bf16 B={STREAMS}: kernel {r['ms']:.4f} ms, "
              f"plain PyTorch {r['plain_ms']:.4f} ms on the device (CUDA "
              f"events, median, queue kept ahead; plain timed "
              f"{r['plain_timing']}); bound "
              f"{1e3 * r['bound_ms']:.3f} us ({r['bound_by']}; "
              f"{r['flops'] / 1e9:.4f} GFLOP, {r['bytes'] / 1e6:.4f} MB); "
              "with the "
              f"host's dispatch: kernel {r['host_ms']:.4f} ms, plain "
              f"{r['plain_host_ms']:.4f} ms per call; on {card}")

    # -- 4. serving FE_B; 6. serving DPT-B ---------------------------------------------
    def serve(model_name, kwargs, tag, phase):
        """Staggered requests through a capacity-256 bf16 fused engine; the
        launch counts are zeroed just before and read just after."""
        model = get_model(model_name, **kwargs, stft_method="matmul")
        hop = model.hop_size
        folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                       device=dev))
        folded_bf16 = cast_floating(folded, torch.bfloat16)
        engine = StreamingEngine(model, folded_bf16, capacity=STREAMS,
                                 dtype=torch.bfloat16, fused=True, device=dev)
        delay_ticks = -(-engine.delay_samples // hop)
        rng = np.random.default_rng(1)
        seconds = (1.0, 1.5, 2.0, 1.25, 1.75, 1.0)
        open_at = (0, 3, 7, 12, 20, 90)  # the last opens after the first closed
        wavs = [rng.uniform(-0.1, 0.1, int(s * SR)).astype(np.float32)
                for s in seconds]
        n_hops = [-(-len(w) // hop) for w in wavs]
        outs = {k: [] for k in range(len(wavs))}
        handles, pos, slots, done = {}, {}, {}, set()
        ticks = 0
        zero_counts()
        t0 = time.perf_counter()
        while len(done) < len(wavs):
            for k, t_open in enumerate(open_at):
                if t_open == ticks:
                    handles[k] = engine.open_stream()
                    slots[k] = engine._slot_of[handles[k]]
                    pos[k] = 0
            feed = {}
            for k, hnd in handles.items():
                seg = np.zeros(hop, np.float32)
                w = wavs[k][pos[k] * hop:(pos[k] + 1) * hop]
                seg[:len(w)] = w
                feed[hnd] = seg
            got = engine.tick(feed)
            ticks += 1
            for k in list(handles):
                outs[k].append(got[handles[k]])
                pos[k] += 1
                if pos[k] == n_hops[k] + delay_ticks:
                    engine.close_stream(handles.pop(k))
                    done.add(k)
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        _check(slots[5] == slots[0], f"slot reuse expected: {slots}")

        results = {}
        for k, chunks in outs.items():
            y = np.concatenate(chunks)[engine.delay_samples:
                                       engine.delay_samples + len(wavs[k])]
            _check(y.shape == (len(wavs[k]),), f"stream {k}: length {y.shape}")
            _check(np.isfinite(y).all(), f"stream {k}: non-finite output")
            results[k] = y

        def isolated(variables, wav, dtype, plan):
            pad = -len(wav) % hop + delay_ticks * hop
            x = torch.from_numpy(np.pad(wav, (0, pad)))[None].to(dev, dtype)
            y = model.stream(variables, x, fused_plan=plan)[0].float().cpu()
            return y.numpy()[engine.delay_samples:
                             engine.delay_samples + len(wav)]

        k = 2  # the longest request, served beside the others
        ref = isolated(folded_bf16, wavs[k], torch.bfloat16,
                       model.build_stack_plan(folded_bf16))
        iso_err = float(np.abs(results[k] - ref).max())
        iso_tol = BF16_REL * float(np.abs(ref).max())
        _check(iso_err <= iso_tol, f"{tag} engine vs isolated: {iso_err} > "
                                   f"{iso_tol}")
        y_fused = isolated(folded, wavs[k], torch.float32,
                           model.build_stack_plan(folded))
        y_plain = isolated(folded, wavs[k], torch.float32, None)
        f32_err = float(np.abs(y_fused - y_plain).max())
        _check(f32_err <= STREAM_F32_TOL,
               f"{tag} fused vs unfused float32: {f32_err} > "
               f"{STREAM_F32_TOL}")
        print(f"[{phase}/11] serving {tag} bf16 capacity {STREAMS}: "
              f"{len(wavs)} requests ({', '.join(f'{s:g}' for s in seconds)} "
              f"s) in {ticks} ticks, slot {slots[0]} reused, launches "
              f"{counts}; all outputs finite and full length; stream {k} vs "
              f"its isolated run max abs err {iso_err:.3e} (tol "
              f"{iso_tol:.3e}); fused vs unfused float32 max abs err "
              f"{f32_err:.3e} (tol {STREAM_F32_TOL:g}); {serve_s:.2f} s wall "
              "(informational)")
        return ticks, counts

    ticks, counts = serve("fastenhancer.default", FE_B, "FE_B", 4)
    check_launches(counts, "rnnformer_stack_step", ticks, "FE_B serving")
    record["rnnformer_stack_step"]["launches"] = counts["rnnformer_stack_step"]

    # -- 5. throughput FE_B; 8. throughput DPT-B ----------------------------------------
    def throughput(model_name, kwargs, tag, seconds, phase, kernel):
        model = get_model(model_name, **kwargs, stft_method="matmul")
        hop = model.hop_size
        folded = cast_floating(model.fold(model.init(
            torch.Generator().manual_seed(0), device=dev)), torch.bfloat16)
        plan = model.build_stack_plan(folded)
        g = torch.Generator().manual_seed(2)
        n_samples = int(seconds * SR) // hop * hop
        wav = (torch.randn(STREAMS, n_samples, generator=g) * 0.05).to(
            dev, torch.bfloat16)
        model.stream(folded, wav[:, :hop * 16], fused_plan=plan)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        y = model.stream(folded, wav, fused_plan=plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        frames = n_samples // hop
        check_launches(counts, kernel, frames, f"{tag} throughput")
        _check(tuple(y.shape) == (STREAMS, n_samples),
               f"stream shape {y.shape}")
        _check(bool(torch.isfinite(y).all()), "non-finite stream output")
        audio_s = n_samples / SR
        rtf = wall / (audio_s * STREAMS)
        print(f"[{phase}/11] throughput {tag} bf16 Model.stream fused, "
              f"{STREAMS} streams x {audio_s:g} s: wall {wall:.3f} s, "
              f"{1e3 * wall / frames:.4f} ms per frame step, per-stream RTF "
              f"{rtf:.4e} = wall/(audio s x streams) on {card}")
        return 1e3 * wall / frames, rtf

    fe_ms, fe_rtf = throughput("fastenhancer.default", FE_B, "FE_B",
                               FE_SECONDS, 5, "rnnformer_stack_step")

    ticks, counts = serve("fastenhancer.dptransformer", DPT_B, "DPT-B", 6)
    check_launches(counts, "dpt_stack_step", ticks, "DPT-B serving")
    record["dpt_stack_step"]["launches"] = counts["dpt_stack_step"]

    # -- 7. whole frame FE_B ---------------------------------------------------------
    model = get_model("fastenhancer.default", **FE_B, stft_method="matmul")
    hop = model.hop_size
    folded = cast_floating(model.fold(model.init(
        torch.Generator().manual_seed(0), device=dev)), torch.bfloat16)
    frame_plan = model.build_frame_plan(folded)
    stack_plan = model.build_stack_plan(folded)
    frames = -(-int(FRAME_SECONDS * SR) // hop)  # at least FRAME_SECONDS
    g = torch.Generator().manual_seed(4)
    wav = (torch.randn(STREAMS, frames * hop, generator=g) * 0.05).to(
        dev, torch.bfloat16)

    def run(step, plan, n):
        carry = model.init_streaming_carry(STREAMS, torch.bfloat16, dev,
                                           fused=True)
        outs = []
        for i in range(n):
            carry, y = step(folded, plan, carry, wav[:, i * hop:(i + 1) * hop])
            outs.append(y)
        return torch.cat(outs, 1)

    run(model.streaming_step_fused_frame, frame_plan, 8)   # warm-up
    run(model.streaming_step_fused, stack_plan, 8)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    y_frame = run(model.streaming_step_fused_frame, frame_plan, frames)
    torch.cuda.synchronize()
    wall_frame = time.perf_counter() - t0
    counts = read_counts()
    check_launches(counts, "fused_frame_step", frames, "whole frame")
    record["fused_frame_step"]["launches"] = counts["fused_frame_step"]
    t0 = time.perf_counter()
    y_stack = run(model.streaming_step_fused, stack_plan, frames)
    torch.cuda.synchronize()
    wall_stack = time.perf_counter() - t0
    _check(tuple(y_frame.shape) == (STREAMS, frames * hop)
           and bool(torch.isfinite(y_frame).all()),
           f"whole frame output {tuple(y_frame.shape)} not finite/full")
    frame_err = (y_frame.float() - y_stack.float()).abs().max().item()
    frame_tol = BF16_REL * y_stack.float().abs().max().item()
    _check(frame_err <= frame_tol, f"whole frame vs streaming_step_fused: "
                                   f"{frame_err:.3e} > {frame_tol:.3e}")
    audio_s = frames * hop / SR
    print(f"[7/11] whole frame FE_B bf16, {STREAMS} streams x {audio_s:g} s: "
          f"streaming_step_fused_frame {1e3 * wall_frame / frames:.4f} ms "
          f"per frame (per-stream RTF "
          f"{wall_frame / (audio_s * STREAMS):.4e}), fused_frame_step "
          f"launches {counts['fused_frame_step']} == frames; "
          f"streaming_step_fused on the same input "
          f"{1e3 * wall_stack / frames:.4f} ms per frame (RTF "
          f"{wall_stack / (audio_s * STREAMS):.4e}; phase 5: {fe_ms:.4f} ms, "
          f"RTF {fe_rtf:.4e}); outputs max abs diff {frame_err:.3e} (tol "
          f"{frame_tol:.3e}) on {card}")

    throughput("fastenhancer.dptransformer", DPT_B, "DPT-B", DPT_SECONDS, 8,
               "dpt_stack_step")

    # -- 9. serving BSRNN-S; 10. serving DPRNN-B; 11. throughput BSRNN-S ----------
    for model_name, kwargs, tag, phase, kernel in (
            ("bsrnn", BSRNN_S, "BSRNN-S", 9, "bsrnn_stack_step"),
            ("fastenhancer.dprnn", DPRNN_B, "DPRNN-B", 10,
             "dprnn_stack_step")):
        ticks, counts = serve(model_name, kwargs, tag, phase)
        check_launches(counts, kernel, ticks, f"{tag} serving")
        record[kernel]["launches"] = counts[kernel]
    throughput("bsrnn", BSRNN_S, "BSRNN-S", BSRNN_SECONDS, 11,
               "bsrnn_stack_step")

    sources = {
        "rnnformer_stack_step": ("rnnformer_stack", "rnnformer_stack.py:394"),
        "fused_frame_step": ("fused_frame", "fused_frame.py:303"),
        "dpt_stack_step": ("dpt_stack", "dpt_stack.py:323"),
        "bsrnn_stack_step": ("bsrnn_stack", "bsrnn_stack.py:249"),
        "dprnn_stack_step": ("dprnn_stack", "dprnn_stack.py:269")}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"fastenhancer_tpu_torch/ops/csrc/{src}.cu",
        "replaces": f"fastenhancer_tpu/ops/{tpu}",
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_us": 1e3 * r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
    } for name, (src, tpu) in sources.items()
        for r in [record[name]]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
