"""Run an exported streaming step (deployment runner).

    python -m fastenhancer_tpu_torch.scripts.run_exported STEP.pt2 \
        --params STEP.pt2.params.pkl -i in.wav -o out.wav [--device cuda]

Counterpart of the repo's scripts/run_exported.py and of the reference's
model-free ONNX runners (scripts/test_onnx.py:16-51): load the program
that `python -m fastenhancer_tpu_torch.scripts.export --save` wrote
(`torch.export.load`), take the variables and the zero carry from its
params pickle, stream a wav hop by hop with cache feedback, write the
result and report RTF and per-tick latency. No model code and no
checkpoint: this imports the kernels' op registry
(`fastenhancer_tpu_torch.ops`, which the program's `fastenhancer::*`
nodes call), the WAV reader and writer, numpy and torch, and nothing of
the models, wrappers or trainer. A spec2spec artifact (its feed is a
[B, F, 1, 2] spectrum frame) gets its STFT and iSTFT here in numpy,
outside the measured step. The artifact runs on the device it was
exported on (`--device`, the first CUDA card unless named).

Caveat for `--fused` artifacts: the block-stack plan is captured in the
program as constants at export time, so feeding a DIFFERENT checkpoint's
.params.pkl would silently keep the export-time block weights; re-export
per checkpoint (see scripts/export.py).
"""
import argparse
import pickle
import time
import typing as tp

import numpy as np
import torch
from torch.fx import _pytree as fx_pytree
from torch.utils import _pytree as pytree

from .. import require_cuda
from .. import ops  # noqa: F401  (registers the fastenhancer::* ops)
from ..data.audio_io import read_wav, write_wav
from ..utils.precision import full_float32


def feed_shape(program) -> tp.Tuple[int, ...]:
    """Shape of the program's last input, the feed: [B, hop] (wav2wav) or
    [B, F, 1, 2] (spec2spec)."""
    name = program.graph_signature.user_inputs[-1]
    node = next(n for n in program.graph.nodes
                if n.op == "placeholder" and n.name == name)
    return tuple(node.meta["val"].shape)


def load(artifact: str, params: str, device: torch.device):
    """-> (the program, its variables and zero carry on `device`, the
    export's meta dict)."""
    program = torch.export.load(artifact)
    # unpickle only a params file this project's export wrote
    with open(params, "rb") as f:
        variables, carry, meta = pickle.load(f)
    variables, carry = pytree.tree_map_only(
        np.ndarray, lambda a: torch.from_numpy(a).to(device),
        (variables, carry))
    return program, variables, carry, meta


def flat_module(step) -> torch.fx.GraphModule:
    """The program's graph as a module called on its flat inputs, in the
    order of `step`'s input spec, returning its flat outputs: `step`'s own
    forward flattens (variables, carry, feed) against that spec at every
    call, in Python (torch.fx's tree_flatten_spec, ~900 calls a tick for
    BSRNN-XT's 511 variable leaves)."""
    graph = torch.fx.Graph()
    graph.output(graph.graph_copy(step.graph, {}))
    return torch.fx.GraphModule(step, graph)


def flat_call(step, variables):
    """-> call(carry, x) running the program's graph on flat inputs
    (`flat_module`) for an `x` already on the device: the variables
    flattened once here, the carry's few leaves each call; -> (carry,
    out), as `step(variables, carry, x)` returns them."""
    var_spec, carry_spec, _ = step._in_spec.children()[0].children()
    var_leaves = fx_pytree.tree_flatten_spec(variables, var_spec)
    flat = flat_module(step)

    def call(carry, x):
        outs = flat(*var_leaves,
                    *fx_pytree.tree_flatten_spec(carry, carry_spec), x)
        return pytree.tree_unflatten(list(outs), step._out_spec)

    return call


def make_call(step, variables, dev: torch.device):
    """-> call(carry, feed) for one tick: the feed (host numpy, or a tensor
    already on `dev`) uploaded, the program run; -> (carry, out). The first
    tick runs `step` itself, which checks every input against the
    program's signature; the later ticks run `flat_call`."""
    run = flat_call(step, variables)
    checked = []

    def call(carry, feed):
        x = feed if torch.is_tensor(feed) else torch.from_numpy(
            np.ascontiguousarray(feed, np.float32)).to(dev)
        if not checked:
            checked.append(True)
            return step(variables, carry, x)
        return run(carry, x)

    return call


def tick_loop(call, carry, feeds):
    """Each feed through `call`, its output fetched to the host (the frame
    is delivered) -> (carry, the outputs, each tick's seconds)."""
    outs, ticks = [], []
    for x in feeds:
        t1 = time.perf_counter()
        carry, y = call(carry, x)
        y = y.cpu().numpy()
        ticks.append(time.perf_counter() - t1)
        outs.append(y)
    return carry, outs, ticks


def wav_feeds(wav: np.ndarray, shape) -> tp.List[np.ndarray]:
    """A mono wav -> the wav2wav feeds, one [B, hop] hop each, the input
    replicated over the B streams the step was exported for (numpy keeps
    the broadcast's layout, so each feed is a transposed view; `make_call`
    hands the program a C-contiguous copy, the layout it was traced on)."""
    _, hop = shape
    t = len(wav) // hop * hop
    return list(np.broadcast_to(wav[:t].reshape(-1, 1, hop),
                                (t // hop,) + tuple(shape)).astype(np.float32))


def main(argv: tp.Optional[tp.Sequence[str]] = None
         ) -> tp.Dict[str, tp.Any]:
    """The CLI; -> {"ticks": each tick's seconds, "amortized_ms"} for a
    caller in the same process."""
    full_float32()
    ap = argparse.ArgumentParser(
        prog="python -m fastenhancer_tpu_torch.scripts.run_exported")
    ap.add_argument("artifact")
    ap.add_argument("--params", required=True,
                    help="pickled (variables, carry0, meta) from the export")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; "
                         "raises when there is none); the one the "
                         "artifact was exported on")
    args = ap.parse_args(argv)

    dev = require_cuda() if args.device is None else torch.device(
        args.device)
    program, variables, carry, meta = load(args.artifact, args.params, dev)
    sr = int(meta["sr"])
    step = program.module()

    call = make_call(step, variables, dev)

    shape = feed_shape(program)
    spec2spec = len(shape) == 4  # [B, F, 1, 2] vs wav2wav [B, hop]
    wav, _ = read_wav(args.input, sr=sr)
    with torch.no_grad():
        if spec2spec:
            # spec-domain artifact (reference: scripts/test_onnx_spec.py):
            # STFT/iSTFT + compression run here in numpy, outside the
            # measured per-tick step, as in the paper's RTF form
            b, f_in, _, _ = shape
            hop, n_fft = int(meta["hop"]), int(meta["n_fft"])
            comp = float(meta["compression"])
            t = (len(wav) - n_fft) // hop * hop + n_fft
            idx = np.arange(0, t - n_fft + 1, hop)
            frames = np.stack([wav[i: i + n_fft] for i in idx])
            spec = np.fft.rfft(frames * meta["window"], axis=-1)[:, :f_in]
            if meta.get("normalized"):
                spec = spec / np.sqrt(n_fft)
            spec = np.stack([spec.real, spec.imag], -1).astype(np.float32)
            mag = np.maximum(np.sqrt((spec ** 2).sum(-1, keepdims=True)),
                             1e-5)
            spec = spec * mag ** (comp - 1.0)
            feeds = [np.broadcast_to(spec[i][None, :, None, :], shape)
                     for i in range(len(idx))]
            t0 = time.perf_counter()
            carry, ys, ticks = tick_loop(call, carry, feeds)
            wall = time.perf_counter() - t0
            hat = np.stack([y[0, :, 0, :] for y in ys])  # [T, F, 2]
            mag = np.maximum(np.sqrt((hat ** 2).sum(-1, keepdims=True)),
                             1e-30)
            hat = hat * mag ** (1.0 / comp - 1.0)
            full = np.zeros((len(idx), n_fft // 2 + 1), np.complex64)
            full[:, :f_in] = hat[..., 0] + 1j * hat[..., 1]
            syn = np.fft.irfft(full, n=n_fft, axis=-1)
            if meta.get("normalized"):
                syn = syn * np.sqrt(n_fft)
            syn = syn * meta["synthesis_window"]
            out = np.zeros(t)
            for j, i in enumerate(idx):
                out[i: i + n_fft] += syn[j]
            # offline OLA is input-aligned (no streaming n_fft-hop delay)
        else:
            hop = shape[1]
            t = len(wav) // hop * hop
            feeds = wav_feeds(wav, shape)
            t0 = time.perf_counter()
            carry, ys, ticks = tick_loop(call, carry, feeds)
            wall = time.perf_counter() - t0
            out = np.concatenate([y[0] for y in ys])
        write_wav(args.output, out, sr)
        # steady state excludes the first tick (the first launches build
        # the kernels); denominator = audio processed by the steady ticks
        steady = np.array(ticks[1:])
        print(f"streamed {t / sr:.1f}s in {wall:.2f}s "
              f"(warm-up tick {ticks[0]:.2f}s) -> {args.output}")
        if not len(steady):
            print("input too short for steady-state latency stats "
                  "(need > 2 hops)")
            return {"ticks": ticks, "amortized_ms": None}
        rtf = float(steady.sum()) / (len(steady) * hop / sr)
        ticks_ms = np.sort(steady * 1000.0)
        budget_ms = hop / sr * 1000.0
        pct = lambda p: float(np.percentile(ticks_ms, p))  # noqa: E731
        misses = float(np.mean(ticks_ms > budget_ms)) * 100.0
        print(f"steady-state RTF {rtf:.4f}")
        print(f"per-tick latency ms: p50 {pct(50):.2f}  p90 {pct(90):.2f}  "
              f"p99 {pct(99):.2f}  (budget {budget_ms:.1f} ms/hop, "
              f"{misses:.1f}% deadline misses)")

        # split dispatch from compute by differencing: rerun the steady
        # ticks without the per-tick host fetch (launches pipeline, and
        # part of the per-dispatch cost amortizes away); p50 minus the
        # amortized ms/frame ~= the host dispatch + fetch cost a deployment
        # host pays per tick. The step's slope is measured by the export
        # script.
        pipe = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
                for x in feeds[:min(len(steady), 256)]]
        t0 = time.perf_counter()
        for x in pipe:
            carry, y = call(carry, x)
        y.cpu()  # single host sync at the end
        amort_ms = (time.perf_counter() - t0) / len(pipe) * 1000.0
        print(f"amortized (pipelined dispatch): {amort_ms:.3f} ms/frame; "
              f"per-dispatch overhead ~{max(pct(50) - amort_ms, 0):.2f} ms "
              f"of the p50 above (the step's slope is measured by the "
              f"export script)")
        return {"ticks": ticks, "amortized_ms": amort_ms}


if __name__ == "__main__":
    main()
