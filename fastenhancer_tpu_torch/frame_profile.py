"""Where a streaming frame's time goes on the card, for each fused path.

    python -m fastenhancer_tpu_torch.frame_profile

For FastEnhancer_B through the block-stack kernel (`streaming_step_fused`),
FastEnhancer_B through the whole-frame kernel (`streaming_step_fused_frame`),
and DPT-B, BSRNN-S and DPRNN-B through their stack kernels
(`streaming_step_fused`), all bfloat16 with folded random-init weights,
over 256 streams and 20 frames, it prints per frame:

* the wall time of the step loop without the profiler (host clock around
  work that ends in a synchronize);
* the device time of every CUDA kernel under `torch.profiler`, the number
  of kernel launches, and the device's busy share (device time over wall);
* the 8 kernels that take the most device time.

Runs on a CUDA card only; it raises without one.
"""
from __future__ import annotations

import time
import typing as tp

import torch

from . import require_cuda
from .models import get_model
from .presets import BSRNN_S, DPRNN_B, DPT_B, FE_B
from .utils import cast_floating

STREAMS = 256
FRAMES = 20
TOP = 8


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, name, None)
        if value is not None:
            return float(value)
    return 0.0


def profile_path(name: str, step: tp.Callable, carry,
                 hops: torch.Tensor) -> None:
    """Warm up, time FRAMES steps on the host clock, then profile them."""
    def run(carry, n):
        for i in range(n):
            carry, _ = step(carry, hops[i % hops.shape[0]])
        return carry

    carry = run(carry, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = run(carry, FRAMES)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / FRAMES
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(carry, FRAMES)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    if device_us == 0:
        raise RuntimeError("the profiler recorded no device time")
    dev_ms = 1e-3 * device_us / FRAMES
    print(f"{name}: wall {wall_ms:.4f} ms per frame (no profiler); device "
          f"{dev_ms:.4f} ms per frame over {launches / FRAMES:.1f} kernel "
          f"launches; device busy {100 * dev_ms / wall_ms:.1f}% of the wall")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP]:
        print(f"    {100 * _device_us(e) / device_us:5.1f}%  "
              f"{_device_us(e) / FRAMES:9.3f} us/frame  "
              f"{e.count / FRAMES:5.1f}/frame  {e.key[:90]}")


def main() -> None:
    dev = require_cuda()
    dt = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    for model_name, kwargs, tag in (("fastenhancer.default", FE_B, "FE_B"),
                                    ("fastenhancer.dptransformer", DPT_B,
                                     "DPT-B"),
                                    ("bsrnn", BSRNN_S, "BSRNN-S"),
                                    ("fastenhancer.dprnn", DPRNN_B,
                                     "DPRNN-B")):
        model = get_model(model_name, **kwargs, stft_method="matmul")
        folded = cast_floating(model.fold(model.init(g, dev)), dt)
        hops = (torch.randn(8, STREAMS, model.hop_size, generator=g)
                * 0.05).to(dev, dt)
        paths = [("streaming_step_fused", model.build_stack_plan(folded),
                  model.streaming_step_fused)]
        if tag == "FE_B":
            paths.append(("streaming_step_fused_frame",
                          model.build_frame_plan(folded),
                          model.streaming_step_fused_frame))
        for step_name, plan, step in paths:
            carry = model.init_streaming_carry(STREAMS, dt, dev, fused=True)
            profile_path(
                f"{tag} {step_name}, {STREAMS} streams, bf16",
                lambda c, x, step=step, plan=plan: step(folded, plan, c, x),
                carry, hops)


if __name__ == "__main__":
    main()
