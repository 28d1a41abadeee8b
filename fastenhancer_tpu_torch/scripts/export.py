"""Deployment path: fold reparameterizations, export the streaming step as
a `torch.export` program, verify streaming == offline, and time the step.

    python -m fastenhancer_tpu_torch.scripts.export -n NAME [--epoch E] \
        [--streams 1] [--test-streaming] [--wav WAV] [--save PATH] \
        [--seconds 10] [--no-fold] [--stft-method fft|matmul] \
        [--spec2spec] [--fused] [--base_dir logs] [--device cuda]

Counterpart of the repo's scripts/export.py. The artifact is
`torch.export.export` of a small module over (variables, carry, feed) at
static shapes, as JAX exports its jitted step: wav2wav feeds a hop
[B, hop] (`Model.streaming_step`, or `streaming_step_fused` with
`--fused`), spec2spec a compressed spectrum frame [B, F, 1, 2]
(`model_forward` or, with `--fused`, `model_forward_fused`, then
`complex_mask_mul`; the STFT runs outside). Each hand-written kernel the
step launches is one `torch.ops.fastenhancer.*` node of the program
(ops/_library.py), so the program runs with no model code:
`python -m fastenhancer_tpu_torch.scripts.run_exported` needs only the
artifact, `PATH.params.pkl` and the op registry. The program keeps the
training IR, in which the dpt stack writes its K/V caches in place; an
artifact runs on the device it was exported on.

Caveat for `--fused` artifacts: the kernel's plan is captured as CONSTANTS
of the program (the block-stack weights of THIS checkpoint), as JAX bakes
its plan into its artifact. The params pickle still holds the full
variables (incl. the now-unused block leaves); feeding a different
checkpoint's variables at run time would silently keep the export-time
block weights. Re-export per checkpoint.
"""
import argparse
import dataclasses
import os
import pickle
import time
import typing as tp

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import add_run_args, load_run
from ..utils.precision import full_float32

# the two run lengths of the per-tick slope, in frames
SLOPE_FRAMES = (128, 640)
# the families with a fused streaming step (their stack kernel)
FUSED_FAMILIES = ("fastenhancer.default, conv_stft, dptransformer, dprnn, "
                  "ln and time_kernel (the FastEnhancer stacks), and bsrnn")


class StepModule(torch.nn.Module):
    """The exported module: step(variables, carry, feed) -> (carry, out)."""

    def __init__(self, step: tp.Callable):
        super().__init__()
        self.step = step

    def forward(self, variables, carry, feed):
        return self.step(variables, carry, feed)


def clone_tree(tree: tp.Any) -> tp.Any:
    """A copy of a carry with fresh tensors (tuples stay tuples, as the
    exported program's input spec wants them)."""
    return pytree.tree_map_only(torch.Tensor, torch.clone, tree)


def make_step(model, variables, streams: int, device: torch.device,
              spec2spec: bool = False, fused: bool = False
              ) -> tp.Tuple[tp.Callable, tp.Any, torch.Tensor]:
    """-> (step(variables, carry, feed) -> (carry, out), carry0, a zero
    feed) of the form the flags name, float32, on `device`. The fused forms
    build the plan here from `variables` (folded) and close over it."""
    b, dt = streams, torch.float32
    if spec2spec:
        if fused:
            plan = model.build_stack_plan(variables)

            def forward(variables, spec, h):
                return model.model_forward_fused(variables, plan, spec, h)
        else:
            def forward(variables, spec, h):
                mask, h_t, _ = model.model_forward(
                    variables["params"], variables["stats"], spec, h0=h)
                return mask, h_t

        def step(variables, carry, spec):
            # spec [B, F, 1, 2] compressed -> enhanced compressed spec
            mask, h_t = forward(variables, spec, carry["h"])
            return dict(carry, h=h_t), model.complex_mask_mul(spec, mask)

        # the FastEnhancer family drops the last bin
        feed = torch.zeros(b, model.stft_cfg.n_freq - 1, 1, 2, device=device)
    elif fused:
        plan = model.build_stack_plan(variables)

        def step(variables, carry, wav_hop):
            return model.streaming_step_fused(variables, plan, carry,
                                              wav_hop)

        feed = torch.zeros(b, model.hop_size, device=device)
    else:
        def step(variables, carry, wav_hop):
            return model.streaming_step(variables, carry, wav_hop)

        feed = torch.zeros(b, model.hop_size, device=device)
    carry0 = model.init_streaming_carry(b, dt, device, fused=fused)
    return step, carry0, feed


def kernel_nodes(program) -> tp.List[str]:
    """The `fastenhancer::*` op of every kernel node of an exported
    program, in graph order."""
    return [n.target.name() for n in program.graph.nodes
            if n.op == "call_function"
            and isinstance(n.target, torch._ops.OpOverload)
            and n.target.namespace == "fastenhancer"]


def main(argv: tp.Optional[tp.Sequence[str]] = None
         ) -> tp.Dict[str, tp.Any]:
    """The CLI; -> what it exported, for a caller in the same process:
    {"program", "step", "variables", "carry0", "feed", "model", "hps"}."""
    full_float32()
    ap = argparse.ArgumentParser(
        prog="python -m fastenhancer_tpu_torch.scripts.export")
    add_run_args(ap)
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent streams in the exported step")
    ap.add_argument("--test-streaming", action="store_true",
                    help="verify frame-by-frame == offline on a test wav")
    ap.add_argument("--wav", default=None,
                    help="the --test-streaming wav (default: a synthesized "
                         "speech-like signal)")
    ap.add_argument("--save", default=None,
                    help="write the exported step with torch.export.save "
                         "(+ PATH.params.pkl)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--no-fold", action="store_true")
    ap.add_argument("--stft-method", default=None,
                    choices=["fft", "matmul"],
                    help="override the STFT form for the exported step "
                         "(matmul = a windowed DFT as a matrix product; "
                         "math-identical)")
    ap.add_argument("--spec2spec", action="store_true",
                    help="export the spec-in/spec-out step (STFT outside), "
                         "the form the paper's RTFs use (reference: "
                         "scripts/export_onnx_spec.py)")
    ap.add_argument("--fused", action="store_true",
                    help="run the family's block-stack kernel in the "
                         "exported step: " + FUSED_FAMILIES)
    args = ap.parse_args(argv)

    hps, wrapper = load_run(args.name, args.base_dir, args.epoch,
                            args.device)
    model = wrapper.model
    dev = wrapper.device
    if args.stft_method:
        model.stft_cfg = dataclasses.replace(model.stft_cfg,
                                             method=args.stft_method)
        print(f"stft method -> {args.stft_method}")
    variables = wrapper.state["variables"]
    if not args.no_fold:
        variables = model.fold(variables)
        print("folded reparameterizations (weight-norm/BN/pre-norm)")
    if args.fused:
        if args.no_fold:
            ap.error("--fused requires folded variables (drop --no-fold)")
        if not hasattr(model, "streaming_step_fused"):
            ap.error(f"--fused: {hps.model} has no fused streaming step; "
                     f"the families with one are {FUSED_FAMILIES}")
    if args.spec2spec:
        # the spec2spec fused step threads ONE carry value through
        # model_forward_fused(variables, plan, spec, carry["h"]); the
        # families that do say so with `spec2spec_fused`. dptransformer
        # (separate kc/vc/ptr) and bsrnn (no spec2spec form) export fused
        # through the wav2wav --fused step instead.
        if args.fused and not getattr(model, "spec2spec_fused", False):
            ap.error("--spec2spec --fused needs a single-carry "
                     "model_forward_fused; this family exports fused via "
                     "the wav2wav form (drop --spec2spec)")
        if not hasattr(model, "complex_mask_mul"):
            ap.error(f"--spec2spec: {hps.model} does not mask a compressed "
                     "spectrum (the FastEnhancer family does)")

    hop = model.hop_size
    b = args.streams
    kind = "spec2spec" if args.spec2spec else "wav2wav"
    with torch.no_grad():
        step, carry0, feed = make_step(model, variables, b, dev,
                                       args.spec2spec, args.fused)
        # one eager step first, as JAX compiles before it exports: the
        # kernels build at their first launch
        step(variables, clone_tree(carry0), feed)
        t0 = time.perf_counter()
        program = torch.export.export(StepModule(step),
                                      (variables, carry0, feed))
        export_s = time.perf_counter() - t0
    nodes = kernel_nodes(program)
    print(f"exported {kind} streaming step: {b} stream(s), hop {hop}, in "
          f"{export_s:.2f} s; kernel nodes: "
          f"{', '.join(nodes) if nodes else 'none'}")

    if args.save:
        # the example inputs would be saved too (the zero carry: DPT-B's
        # K/V caches at 256 streams are 165 MB); the params pickle holds it
        program.example_inputs = None
        torch.export.save(program, args.save)
        cfg = model.stft_cfg
        # DSP meta so the spec2spec runner can do STFT/iSTFT outside the
        # artifact (reference: scripts/test_onnx_spec.py keeps the FFT out
        # of the measured graph)
        meta = {
            "sr": hps.data.sampling_rate,
            "hop": cfg.hop_size,
            "n_fft": cfg.n_fft,
            "window": np.asarray(cfg.window_f32),
            "synthesis_window": np.asarray(cfg.synthesis_window),
            "compression": getattr(model, "input_compression", 1.0),
            "normalized": bool(cfg.normalized),
        }
        host = pytree.tree_map_only(
            torch.Tensor, lambda t: t.detach().cpu().numpy(),
            (variables, carry0))
        with open(args.save + ".params.pkl", "wb") as f:
            pickle.dump((*host, meta), f)
        print(f"serialized exported step -> {args.save} "
              f"({os.path.getsize(args.save)} bytes) "
              f"+ {args.save}.params.pkl")

    run = program.module()
    sr = hps.data.sampling_rate
    with torch.no_grad():
        if args.test_streaming:
            _test_streaming(args, model, wrapper, variables, b, hop, sr)
        _time_ticks(run, variables, carry0, feed, b, hop, sr, args.seconds,
                    dev)
    return dict(program=program, step=step, variables=variables,
                carry0=carry0, feed=feed, model=model, hps=hps)


def _test_streaming(args, model, wrapper, variables, b: int, hop: int,
                    sr: int) -> None:
    """Model.stream against the offline graph on one wav, as JAX's script
    does; prints the SNR after the n_fft - hop streaming delay."""
    from ..data import read_wav

    if args.wav is not None:
        wav, _ = read_wav(args.wav, sr=sr)
    else:  # no corpus: synthesize a speech-like test signal
        tt = np.arange(4 * sr) / sr
        wav = sum(0.1 * np.sin(2 * np.pi * f * tt)
                  for f in (220, 440, 880, 1760))
        wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * tt))
    t = len(wav) // hop * hop
    wav = np.asarray(wav[:t][None], np.float32)
    dev = wrapper.device
    y_stream = model.stream(variables, torch.from_numpy(
        np.repeat(wav, b, 0)).to(dev))[0].cpu().numpy()
    wav_hat = wrapper.infer_fn(variables, torch.from_numpy(wav).to(dev)
                               )[0].cpu().numpy()
    # streaming output is delayed n_fft - hop samples (docs/docs/onnx.md)
    a = y_stream[model.stft_cfg.cache_len:]
    c = wav_hat[: len(a)]
    err = np.mean((a - c) ** 2)
    sig = np.mean(c ** 2)
    print(f"streaming vs offline: diff MSE {err:.3e} "
          f"(SNR {10 * np.log10(sig / max(err, 1e-20)):.1f} dB)")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_ticks(run, variables, carry0, feed: torch.Tensor, b: int,
                hop: int, sr: int, seconds: float, dev: torch.device
                ) -> None:
    """The per-tick line (a host fetch every tick) and the slope line (two
    run lengths, one sync a run) of the exported step."""
    n_frames = min(int(seconds * sr) // hop, 200)
    rng = np.random.default_rng(0)

    def feeds(n):
        return torch.from_numpy(rng.standard_normal(
            (n,) + tuple(feed.shape)).astype(np.float32)).to(dev)

    hops = feeds(n_frames)
    carry = clone_tree(carry0)
    carry, out = run(variables, carry, feed)  # warm-up
    float(out.sum())
    ticks = []
    acc = 0.0
    for i in range(n_frames):
        t0 = time.perf_counter()
        carry, out = run(variables, carry, hops[i])
        acc += float(out.sum())  # host fetch = the frame is delivered
        ticks.append(time.perf_counter() - t0)
    ticks_ms = np.sort(np.array(ticks) * 1e3)
    pct = lambda p: float(np.percentile(ticks_ms, p))  # noqa: E731
    print(f"per-tick from this host (sync each): p50 {pct(50):.2f} ms  "
          f"p99 {pct(99):.2f} ms ({b} stream(s); checksum {acc:.3e})")

    # the step over two run lengths with no host sync inside a run: the
    # wall-time difference over the frame difference cancels the fixed
    # cost of a run. JAX scans its step on the device; here every frame is
    # dispatched from the host, so this is the host's dispatch rate or the
    # device's, whichever is slower.
    n1, n2 = SLOPE_FRAMES
    walls = {}
    for n in (n1, n2):
        xs = feeds(n)
        best = float("inf")
        for _ in range(3):
            c = clone_tree(carry0)
            total = torch.zeros((), device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            for x in xs:
                c, y = run(variables, c, x)
                total += y.sum()
            float(total)  # host fetch = completion
            best = min(best, time.perf_counter() - t0)
        walls[n] = best
    us = (walls[n2] - walls[n1]) / (n2 - n1) * 1e6
    budget_ms = hop / sr * 1e3
    print(f"per-tick slope ({n1} vs {n2} frames, one sync a run): "
          f"{us:.1f} us/frame -> {us / 1e3 / budget_ms * 100:.2f}% of the "
          f"{budget_ms:.1f} ms/hop deadline ({b} stream(s)); host-dispatch-"
          f"bound until the step runs as a CUDA graph")


if __name__ == "__main__":
    main()
