"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It drives FastEnhancer_B's streaming serving path of `fastenhancer_tpu_torch`
(no JAX anywhere) through the hand-written CUDA kernels, in five phases,
each printed on its own line:

  1. card: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for the float32 checks;
  2. build: every kernel of the path compiled from this checkout with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the FastEnhancer T/B/S block shapes in float32 and bfloat16, and both
     timed with CUDA events at FastEnhancer_B bfloat16;
  4. serving: a StreamingEngine (capacity 256, bfloat16, fused) answers a
     few staggered requests; outputs are checked for length, finiteness,
     agreement with an isolated run, and the kernel's launch count; the
     unfused float32 path is checked against the fused one;
  5. throughput: Model.stream over 256 streams x 10 s in bfloat16, reported
     as per-stream RTF = wall / (audio seconds x streams).

The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero, and
so does a machine without a CUDA device.
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
    from __graft_entry__ import FLAGSHIP_KWARGS
    from fastenhancer_tpu_torch import require_cuda
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.ops import _build
    from fastenhancer_tpu_torch.ops import rnnformer_stack as stack
    from fastenhancer_tpu_torch.serving import StreamingEngine
    from fastenhancer_tpu_torch.utils import cast_floating

    dev = require_cuda()

    # -- 1. card -----------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    card = f"[{smi}]"
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1/5] card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} "
          f"| torch {torch.__version__}, CUDA {torch.version.cuda} | TF32 off "
          "for matmul and cuDNN (float32 checks run in full float32)")

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build("rnnformer_stack", verbose=True)
    print(f"[2/5] build: rnnformer_stack.cu with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 3. kernel vs plain --------------------------------------------------------
    def random_case(b, f, c, nb, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(
            dev, dtype) for k, s in stack.plan_shapes(nb, f, c).items()}
        x = torch.randn(b, f, c, generator=g).to(dev, dtype)
        h = (torch.randn(nb, b * f, c, generator=g) * 0.5).to(dev, dtype)
        return plan, x, h

    def time_ms(fn, reps=7, inner=20):
        """Median over `reps` of CUDA-event time per call, each over
        `inner` back-to-back calls, after a warm-up."""
        for _ in range(5):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    heads = 4
    fe_b_err = None
    for name, (b, f, c, nb) in (("FE_B", (256, 24, 36, 3)),
                                ("FE_T", (256, 16, 20, 2)),
                                ("FE_S", (256, 36, 48, 3))):
        for dtype in (torch.float32, torch.bfloat16):
            plan, x, h = random_case(b, f, c, nb, dtype, seed=f * c)
            xo, ho = stack.rnnformer_stack_step(plan, x, h, heads)
            torch.cuda.synchronize()
            xr, hr = stack.rnnformer_stack_reference(plan, x, h, heads)
            errs = []
            for got, want in ((xo, xr), (ho, hr)):
                want = want.float()
                err = (got.float() - want).abs().max().item()
                tol = (F32_TOL if dtype == torch.float32
                       else BF16_REL * want.abs().max().item())
                _check(err <= tol, f"{name} {dtype}: kernel vs plain max abs "
                                   f"err {err:.3e} > {tol:.3e}")
                errs.append((err, tol))
            print(f"[3/5] kernel rnnformer_stack {name} B={b} F={f} C={c} "
                  f"H={heads} NB={nb} {str(dtype)[6:]}: max abs err x_out "
                  f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), h_new "
                  f"{errs[1][0]:.3e} (tol {errs[1][1]:.3e})")
            if name == "FE_B" and dtype == torch.bfloat16:
                fe_b_err = max(errs[0][0], errs[1][0])
                kernel_ms = time_ms(
                    lambda: stack.rnnformer_stack_step(plan, x, h, heads))
                plain_ms = time_ms(
                    lambda: stack.rnnformer_stack_reference(plan, x, h, heads))
                print(f"[3/5] time FE_B bf16 B=256: kernel {kernel_ms:.4f} ms, "
                      f"plain PyTorch {plain_ms:.4f} ms per frame's stack "
                      f"(CUDA events, median) on {card}")

    # -- 4. serving ------------------------------------------------------------------
    model = get_model("fastenhancer.default", **FLAGSHIP_KWARGS,
                      stft_method="matmul")
    hop = model.hop_size
    folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                   device=dev))
    folded_bf16 = cast_floating(folded, torch.bfloat16)
    engine = StreamingEngine(model, folded_bf16, capacity=256,
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
    stack.rnnformer_stack_step.launches = 0
    ticks = 0
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
    launches = stack.rnnformer_stack_step.launches
    _check(launches == ticks, f"kernel launches {launches} != ticks {ticks}")
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
    _check(iso_err <= iso_tol, f"engine vs isolated: {iso_err} > {iso_tol}")
    y_fused = isolated(folded, wavs[k], torch.float32,
                       model.build_stack_plan(folded))
    y_plain = isolated(folded, wavs[k], torch.float32, None)
    f32_err = float(np.abs(y_fused - y_plain).max())
    _check(f32_err <= STREAM_F32_TOL,
           f"fused vs unfused float32: {f32_err} > {STREAM_F32_TOL}")
    print(f"[4/5] serving FE_B bf16 capacity 256: {len(wavs)} requests "
          f"({', '.join(f'{s:g}' for s in seconds)} s) in {ticks} ticks, "
          f"slot {slots[0]} reused, kernel launches {launches} == ticks; "
          f"all outputs finite and full length; stream {k} vs its isolated "
          f"run max abs err {iso_err:.3e} (tol {iso_tol:.3e}); fused vs "
          f"unfused float32 max abs err {f32_err:.3e} (tol "
          f"{STREAM_F32_TOL:g}); {serve_s:.2f} s wall (informational)")

    # -- 5. throughput -------------------------------------------------------------
    streams, secs = 256, 10.0
    plan = model.build_stack_plan(folded_bf16)
    g = torch.Generator().manual_seed(2)
    n_samples = int(secs * SR) // hop * hop
    wav = (torch.randn(streams, n_samples, generator=g) * 0.05).to(
        dev, torch.bfloat16)
    model.stream(folded_bf16, wav[:, :hop * 16], fused_plan=plan)  # warm-up
    torch.cuda.synchronize()
    before = stack.rnnformer_stack_step.launches
    t0 = time.perf_counter()
    y = model.stream(folded_bf16, wav, fused_plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames = n_samples // hop
    _check(stack.rnnformer_stack_step.launches - before == frames,
           "throughput run did not launch the kernel once per frame")
    _check(tuple(y.shape) == (streams, n_samples), f"stream shape {y.shape}")
    _check(bool(torch.isfinite(y).all()), "non-finite stream output")
    audio_s = n_samples / SR
    rtf = wall / (audio_s * streams)
    print(f"[5/5] throughput FE_B bf16 Model.stream fused, {streams} streams x "
          f"{audio_s:g} s: wall {wall:.3f} s, {1e3 * wall / frames:.4f} ms per "
          f"frame step, per-stream RTF {rtf:.4e} = wall/(audio s x streams) "
          f"on {card}")

    print(json.dumps({"kernels": [{
        "name": "rnnformer_stack_step",
        "route": "cuda",
        "source": "fastenhancer_tpu_torch/ops/csrc/rnnformer_stack.cu",
        "replaces": "fastenhancer_tpu/ops/rnnformer_stack.py:394",
        "launches": launches,
        "max_abs_err": fe_b_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
