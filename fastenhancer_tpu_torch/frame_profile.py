"""Where a streaming frame's, and a training step's, time goes on the card.

    python -m fastenhancer_tpu_torch.frame_profile

For FastEnhancer_B through the block-stack kernel (`streaming_step_fused`),
FastEnhancer_B through the whole-frame kernel (`streaming_step_fused_frame`),
DPT-B, BSRNN-S and DPRNN-B through their stack kernels, and the ln
ablation's LN_B through the block stack's LN form (`streaming_step_fused`
each), all bfloat16 with folded random-init weights,
over 256 streams and 20 frames; FastEnhancer_B's chunked stream
(`streaming_chunk` of 4 and of 8 frames, each block's time GRU one GRU-scan
launch a chunk) over 256 streams and 20 chunks, per frame; the noncausal
model at the huge recipe's widths (`presets.NONCAUSAL_HUGE`), one offline
`forward` of 4 streams x 4 s, per forward; the FSPEN and LiSenNet baselines
(`presets.FSPEN`, `presets.LISENNET`; every GRU one GRU-scan launch) over
256 streams unfused, per frame (`streaming_step`) and per frame of a
`streaming_chunk` of 4 over 20 steps, and their offline `forward` of 4 x 4
s, per forward; and for the shard recipe's FE-T
(`presets.FE_T_SHARD`) a train step (the mix and the bf16 step) at
32 x 4 s over 3 steps and a valid step at 64 x 2 s over 20 steps, it
prints per frame or step:

* the wall time of the loop without the profiler (host clock around work
  that ends in a synchronize);
* the device time of every CUDA kernel under `torch.profiler`, the number
  of kernel launches, and the device's busy share (device time over wall);
* the 8 kernels that take the most device time.

Runs on a CUDA card only; it raises without one.
"""
from __future__ import annotations

import time
import typing as tp

import numpy as np
import torch

from . import require_cuda
from .data import ShardBatch
from .models import get_model
from .presets import (BSRNN_S, DPRNN_B, DPT_B, FE_B, FE_T_SHARD, FSPEN,
                      LISENNET, LN_B, NONCAUSAL_HUGE)
from .utils import cast_floating
from .utils.hparams import HParams
from .wrappers import get_wrapper

STREAMS = 256
FRAMES = 20
TOP = 8
TRAIN_STEPS = 3


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, name, None)
        if value is not None:
            return float(value)
    return 0.0


def profile_path(name: str, step: tp.Callable, carry,
                 hops: tp.Sequence[tp.Any], frames: int = FRAMES,
                 warmup: int = 5, unit: str = "frame",
                 per_step: int = 1) -> None:
    """Warm up, time `frames` steps on the host clock, then profile them;
    each step is `per_step` units (the frames of a chunk), and the numbers
    are printed per unit."""
    def run(carry, n):
        for i in range(n):
            carry, _ = step(carry, hops[i % len(hops)])
        return carry

    carry = run(carry, warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = run(carry, frames)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(carry, frames)
        torch.cuda.synchronize()
    frames *= per_step  # the units the steps cover
    wall_ms = 1e3 * wall_s / frames
    # a record_function range (torch.optim's "Optimizer.step#...") also
    # shows on the device's track; it is not a kernel, so it is left out
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    if device_us == 0:
        raise RuntimeError("the profiler recorded no device time")
    dev_ms = 1e-3 * device_us / frames
    print(f"{name}: wall {wall_ms:.4f} ms per {unit} (no profiler); device "
          f"{dev_ms:.4f} ms per {unit} over {launches / frames:.1f} kernel "
          f"launches; device busy {100 * dev_ms / wall_ms:.1f}% of the wall")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP]:
        print(f"    {100 * _device_us(e) / device_us:5.1f}%  "
              f"{_device_us(e) / frames:9.3f} us/{unit}  "
              f"{e.count / frames:7.1f}/{unit}  {e.key[:90]}")


def profile_training(dev: torch.device) -> None:
    """The shard recipe's FE-T: a train step (the mix on the card and the
    bf16 step) on a batch of 32 x 4 s (128 s, the recipe's max_duration),
    and a valid step on 64 x 2 s. Random audio; RIRs are unit impulses."""
    wrapper = get_wrapper(FE_T_SHARD["wrapper"])(HParams(**FE_T_SHARD),
                                                 train=True, device=dev)
    rng = np.random.default_rng(0)
    rows, n = 32, 64_000
    speech = (rng.standard_normal((rows, 1, n)) * 0.1).astype(np.float32)
    rir = np.zeros((rows, 1, 8_000), np.float32)
    rir[:, 0, 0] = 1.0
    batch = ShardBatch(
        speech=speech, speech_clean=speech, noise=speech[::-1] * 0.5,
        rir=rir, rir_onset=np.zeros(rows, np.int64),
        rir_t60=np.full(rows, 1e-3, np.float32),
        num_samples=np.full(rows, n), id_speech=[""] * rows)

    def train(carry, batch):
        wrapper._step_and_account(*wrapper._mix_to_device(batch))
        return carry, None

    profile_path("FE-T shard train step (mix + bf16 step), 32 x 4 s", train,
                 None, [batch], frames=TRAIN_STEPS, warmup=2, unit="step")
    clean = speech[:, 0].reshape(64, 32_000)
    valid, _ = wrapper._device_batch({"clean": clean, "noisy": clean * 0.8},
                                     ("clean", "noisy"))

    def validate(carry, batch):
        wrapper.valid_step(wrapper.state["variables"], batch)
        return carry, None

    profile_path("FE-T valid step (bf16), 64 x 2 s", validate, None, [valid],
                 unit="step")


def profile_chunks_and_noncausal(dev: torch.device) -> None:
    """FE_B's chunked stream (4 and 8 frames a chunk) per frame, and the
    huge noncausal model's offline forward, bf16."""
    dt = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    model = get_model("fastenhancer.default", **FE_B, stft_method="matmul")
    folded = cast_floating(model.fold(model.init(g, dev)), dt)
    for c in (4, 8):
        chunks = (torch.randn(4, STREAMS, c * model.hop_size, generator=g)
                  * 0.05).to(dev, dt)
        profile_path(
            f"FE_B streaming_chunk of {c} frames, {STREAMS} streams, bf16",
            lambda carry, x: model.streaming_chunk(folded, carry, x),
            model.init_streaming_carry(STREAMS, dt, dev), chunks,
            per_step=c)
    model = get_model("fastenhancer.noncausal", **NONCAUSAL_HUGE)
    variables = cast_floating(model.fold(model.init(g, dev)), dt)
    wav = (torch.randn(4, 64_000, generator=g) * 0.05).to(dev, dt)

    def forward(carry, x):
        model.forward(variables, x)
        return carry, None

    profile_path("noncausal NONCAUSAL_HUGE forward, 4 x 4 s, bf16", forward,
                 None, [wav], frames=5, warmup=2, unit="forward")


def profile_baselines(dev: torch.device) -> None:
    """FSPEN and LiSenNet, bf16, unfused (they have no stack plan): a
    frame and a chunk of 4 over 256 streams, per frame, and the offline
    forward of 4 x 4 s."""
    dt = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    for model_name, kwargs, tag in (("fspen", FSPEN, "FSPEN"),
                                    ("lisennet", LISENNET, "LiSenNet")):
        model = get_model(model_name, **kwargs, stft_method="matmul")
        folded = cast_floating(model.fold(model.init(g, dev)), dt)
        for c in (1, 4):
            chunks = (torch.randn(4, STREAMS, c * model.hop_size,
                                  generator=g) * 0.05).to(dev, dt)
            profile_path(
                f"{tag} {'streaming_step' if c == 1 else 'streaming_chunk'}"
                f" of {c} frame{'s' if c > 1 else ''}, {STREAMS} streams, "
                "bf16", lambda carry, x: model.streaming_chunk(folded, carry,
                                                               x),
                model.init_streaming_carry(STREAMS, dt, dev), chunks,
                per_step=c)
        wav = (torch.randn(4, 64_000, generator=g) * 0.05).to(dev, dt)

        def forward(carry, x):
            model.forward(folded, x)
            return carry, None

        profile_path(f"{tag} forward, 4 x 4 s, bf16", forward, None, [wav],
                     frames=5, warmup=2, unit="forward")


def main() -> None:
    dev = require_cuda()
    dt = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    for model_name, kwargs, tag in (("fastenhancer.default", FE_B, "FE_B"),
                                    ("fastenhancer.dptransformer", DPT_B,
                                     "DPT-B"),
                                    ("bsrnn", BSRNN_S, "BSRNN-S"),
                                    ("fastenhancer.dprnn", DPRNN_B,
                                     "DPRNN-B"),
                                    ("fastenhancer.ln", LN_B, "LN_B")):
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
    profile_chunks_and_noncausal(dev)
    profile_baselines(dev)
    profile_training(dev)


if __name__ == "__main__":
    main()
