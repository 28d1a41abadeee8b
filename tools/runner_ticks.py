"""Why the exported runner's ticks in a fresh process differ from the same
program run in a loop there: one change at a time, each in its own fresh
process.

    python tools/runner_ticks.py [--out FILE] [--families xt,fe,dpt,dprnn]
                                 [--modes MODE,...]

Each family's config is written as an untrained run and exported with
`scripts/export.py --fused` at STREAMS streams, float32 (FAMILIES: BSRNN-XT,
FE-B DNS, DPT-B, DPRNN-B). Then each mode runs in a fresh process
(`python tools/runner_ticks.py --child MODE SPEC`):

- order: the loaded program in a loop (LOOP_FRAMES random feeds already on
  the card, each output fetched), the runner's `main` on SHORT_SECONDS of
  speech-like input, `main` again, and the loop again.
- ticks[-disable|-freeze]: the runner's tick loop outside `main` on
  LONG_SECONDS: each tick's ms, the garbage collector's ms in it, and after
  each of the first MEM_TICKS ticks the caching allocator's cudaMalloc
  calls (`segment.all.allocated`) and `num_alloc_retries`; p50 over ticks
  2-15 and 16 on (from 1); then, warm, blocks of BLOCK frames: the feeds
  on the card, uploaded from host numpy as the runner does, and random.
  `-disable`: `gc.disable()`; `-freeze`: `gc.freeze()` after the load.
- cprofile: that tick loop under cProfile (no torch.profiler).
- main-WAV[-pytree] (WAV short or long): the runner's `main` alone, its
  tick loop watched: each thread's CPU seconds, the collector's ms a tick,
  the program's input flatten alone a tick, and the interpreter's hooks.
  `-pytree`: every tick through the program's own forward, as the runner
  ran before its ticks took the graph's flat inputs.
- mprof-WAV[-pytree]: `main` with its tick loop under cProfile.
- loop-WAV[-pytree]: `main`'s steps outside `main`, watched as main-WAV.

By default the first family gets FIRST_MODES and the others OTHER_MODES.
Prints one line a mode with the card's name and power limit and writes
all of them as JSON to --out. Runs on a CUDA card unless a caller's
`DEVICE` says otherwise.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STREAMS = 256
SHORT_SECONDS, LONG_SECONDS = 0.25, 2.0
LOOP_FRAMES, BLOCK, MEM_TICKS = 16, 32, 20
SLOPE = (4, 12)               # the export's two slope run lengths, cut
FIRST = 15                    # ticks 1 .. FIRST - 1 (from 0) are "early"
# tag -> (config, -p overrides)
FAMILIES = {"xt": ("others_dns/bsrnn_xt.yaml", []),
            "fe": ("fastenhancer_dns/b.yaml", []),
            "dpt": ("ablation/dpt_b.yaml", []),
            "dprnn": ("ablation/dprnn_b.yaml", [])}
FIRST_MODES = ["order", "ticks", "ticks-disable", "ticks-freeze", "cprofile",
               "main-short-pytree", "main-short", "mprof-short-pytree",
               "mprof-short", "loop-short-pytree", "loop-short"]
OTHER_MODES = ["order", "main-short-pytree", "main-short"]
DEVICE = None                 # None: the first CUDA card


def speech_like(n: int, sr: int) -> np.ndarray:
    """chip_smoke.py's speech-like row: noise under a 3 Hz envelope, silent
    for a sixth."""
    rng = np.random.default_rng(27)
    tt = np.arange(n) / sr
    x = rng.standard_normal(n) * 0.1 * (
        0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * tt + rng.uniform(0, 2 * np.pi)))
    x[n // 3: n // 2] = 0.0
    return x.astype(np.float32)


def export_family(tag: str, root: str) -> dict:
    """An untrained run of FAMILIES[tag] exported --fused -> the spec a
    child reads."""
    from fastenhancer_tpu_torch.data.audio_io import write_wav
    from fastenhancer_tpu_torch.scripts import export
    from fastenhancer_tpu_torch.utils.hparams import get_hparams
    from fastenhancer_tpu_torch.wrappers import get_wrapper

    config, overrides = FAMILIES[tag]
    run = os.path.join(root, "logs", tag)
    hps = get_hparams(os.path.join(REPO, "configs", config), base_dir=run,
                      save=True, params=list(overrides))
    dev = torch.device(DEVICE) if DEVICE else torch.device("cuda")
    get_wrapper(hps.wrapper)(hps, train=False, device=dev).save(1)
    art = os.path.join(root, f"{tag}.pt2")
    slope, export.SLOPE_FRAMES = export.SLOPE_FRAMES, SLOPE
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            export.main(["-n", tag, "--base_dir", os.path.join(root, "logs"),
                         "--streams", str(STREAMS), "--save", art,
                         "--seconds", str(SHORT_SECONDS), "--fused",
                         *(["--device", DEVICE] if DEVICE else [])])
    finally:
        export.SLOPE_FRAMES = slope
    sr = hps.data.sampling_rate
    wavs = {}
    for name, seconds in (("short", SHORT_SECONDS), ("long", LONG_SECONDS)):
        wavs[name] = os.path.join(root, f"{tag}_{name}.wav")
        write_wav(wavs[name], speech_like(int(seconds * sr), sr), sr)
    return dict(tag=tag, config=config, artifact=art,
                params=art + ".params.pkl", wavs=wavs, device=DEVICE,
                out=os.path.join(root, f"{tag}_out.wav"))


# -- the fresh processes ------------------------------------------------------

def _dev(spec):
    return torch.device(spec["device"] or "cuda")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _p50(ticks_s, lo, hi=None):
    t = np.asarray(ticks_s[lo:hi]) * 1e3
    return float(np.median(t)) if len(t) else None


def _main(spec, wav):
    """The runner's main on `wav` -> its result."""
    from fastenhancer_tpu_torch.scripts import run_exported

    with contextlib.redirect_stdout(io.StringIO()):
        return run_exported.main(
            [spec["artifact"], "--params", spec["params"], "-i",
             spec["wavs"][wav], "-o", spec["out"],
             *(["--device", spec["device"]] if spec["device"] else [])])


def pytree_call(step, variables, dev):
    """The runner's call as it was before its ticks took the graph's flat
    inputs: every tick through the program's own forward, the input check
    on the first only."""
    def call(carry, feed):
        x = feed if torch.is_tensor(feed) else torch.from_numpy(
            np.ascontiguousarray(feed, np.float32)).to(dev)
        out = step(variables, carry, x)
        step.validate_inputs = False
        return out

    return call


class GcTimer:
    """The garbage collector's seconds and collections by generation, from
    gc.callbacks."""

    def __init__(self):
        self.s, self.n, self._t0 = 0.0, [0, 0, 0], None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t0
            self.n[info["generation"]] += 1

    def read(self):
        return self.s, list(self.n)

    def close(self):
        gc.callbacks.remove(self)


def thread_cpu():
    """{thread id: (name, CPU seconds)} of this process, from /proc."""
    hz = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
        except OSError:
            continue
        out[tid] = (name, (int(fields[11]) + int(fields[12])) / hz)
    return out


def interpreter_state():
    """What could make every Python frame of this thread slower: a trace
    or profile function, sys.monitoring tools, Dynamo's frame callback."""
    from torch._C._dynamo.eval_frame import get_eval_frame_callback

    tools = [sys.monitoring.get_tool(i) for i in range(6)]
    return {"trace": repr(sys.gettrace()), "profile": repr(sys.getprofile()),
            "monitoring": [t for t in tools if t],
            "eval_frame": repr(get_eval_frame_callback())[:120]}


def watched(loop, made, log):
    """run_exported.tick_loop `loop` watched: each thread's CPU seconds
    over it, the collector's ms a tick, the program's input flatten alone
    a tick (`made` holds the step and variables the call was made with),
    and the interpreter's hooks at the second tick."""
    from torch.fx._pytree import tree_flatten_spec

    def run(call, carry, feeds):
        timer, gc_ms, flat_ms = GcTimer(), [], []

        def tick(carry, x):
            g0, _ = timer.read()
            out = call(carry, x)
            gc_ms.append((timer.read()[0] - g0) * 1e3)
            if len(gc_ms) == 2:
                log["state"] = interpreter_state()
            t0 = time.perf_counter()
            tree_flatten_spec(([made["variables"], carry, out[1]], {}),
                              made["step"]._in_spec)
            flat_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        before = thread_cpu()
        t0 = time.perf_counter()
        res = loop(tick, carry, feeds)
        log["wall_s"] = time.perf_counter() - t0
        after = thread_cpu()
        timer.close()
        log["threads_cpu_s"] = sorted(
            ((round(c - before.get(t, (n, 0.0))[1], 2), n, t)
             for t, (n, c) in after.items()), reverse=True)[:4]
        log["python_threads"] = [t.name for t in threading.enumerate()]
        log["gc_ms"], log["flatten_ms"] = gc_ms, flat_ms
        return res

    return run


def _install(made, variant):
    """run_exported.make_call, the `-pytree` variant's or its own, keeping
    the step and variables it was made with in `made`."""
    from fastenhancer_tpu_torch.scripts import run_exported

    make = pytree_call if variant == "pytree" else run_exported.make_call

    def make_call(step, variables, dev):
        made.update(step=step, variables=variables)
        return make(step, variables, dev)

    run_exported.make_call = make_call


def child_main(spec, wav, variant):
    from fastenhancer_tpu_torch.scripts import run_exported

    made, log = {}, {}
    _install(made, variant)
    run_exported.tick_loop = watched(run_exported.tick_loop, made, log)
    res = _main(spec, wav)
    log.update(ticks_ms=[t * 1e3 for t in res["ticks"]],
               p50_ms=_p50(res["ticks"], 1),
               amortized_ms=res["amortized_ms"])
    return log


def _profile_rows(prof, n):
    import pstats

    rows = [(tt / n * 1e3, ct / n * 1e3, nc / n,
             f"{os.path.basename(f)}:{line}({fn})")
            for (f, line, fn), (_, nc, tt, ct, _) in
            pstats.Stats(prof).stats.items()]
    return {"own": sorted(rows, reverse=True)[:12],
            "inclusive": sorted(rows, key=lambda r: -r[1])[:16]}


def child_mprof(spec, wav, variant):
    """main with its tick loop under cProfile: the costliest functions, own
    and inclusive ms a tick."""
    import cProfile

    from fastenhancer_tpu_torch.scripts import run_exported

    prof, loop = cProfile.Profile(), run_exported.tick_loop

    def profiled(call, carry, feeds):
        prof.enable()
        try:
            return loop(call, carry, feeds)
        finally:
            prof.disable()

    _install({}, variant)
    run_exported.tick_loop = profiled
    res = _main(spec, wav)
    return dict(_profile_rows(prof, len(res["ticks"])),
                ticks_ms=[t * 1e3 for t in res["ticks"]],
                p50_ms=_p50(res["ticks"], 1))


def _prepare(spec, wav, variant="", made=None):
    """main's steps before its tick loop, outside main -> (call, carry,
    feeds, dev)."""
    from fastenhancer_tpu_torch.data.audio_io import read_wav
    from fastenhancer_tpu_torch.scripts import run_exported
    from fastenhancer_tpu_torch.utils.precision import full_float32

    full_float32()
    dev = _dev(spec)
    program, variables, carry, meta = run_exported.load(
        spec["artifact"], spec["params"], dev)
    step = program.module()
    make = pytree_call if variant == "pytree" else run_exported.make_call
    call = make(step, variables, dev)
    if made is not None:
        made.update(step=step, variables=variables)
    wav, _ = read_wav(spec["wavs"][wav], sr=int(meta["sr"]))
    feeds = run_exported.wav_feeds(wav, run_exported.feed_shape(program))
    return call, carry, feeds, dev


def child_loop(spec, wav, variant):
    from fastenhancer_tpu_torch.scripts import run_exported

    made, log = {}, {}
    call, carry, feeds, _ = _prepare(spec, wav, variant, made)
    with torch.no_grad():
        _, _, ticks = watched(run_exported.tick_loop, made, log)(
            call, carry, feeds)
    log.update(ticks_ms=[t * 1e3 for t in ticks], p50_ms=_p50(ticks, 1))
    return log


def _loop_ms(spec):
    """The loaded program over LOOP_FRAMES random feeds already on the
    card, each output fetched, the input check on the first call only ->
    ms a frame."""
    from fastenhancer_tpu_torch.scripts import run_exported

    dev = _dev(spec)
    program, variables, carry, _ = run_exported.load(
        spec["artifact"], spec["params"], dev)
    step = program.module()
    shape = run_exported.feed_shape(program)
    rng = np.random.default_rng(270)
    xs = [torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(
        np.float32)).to(dev) for _ in range(LOOP_FRAMES + 1)]
    with torch.no_grad():
        carry, y = step(variables, carry, xs[0])
        y.cpu()
        step.validate_inputs = False
        t0 = time.perf_counter()
        for x in xs[1:]:
            carry, y = step(variables, carry, x)
            y.cpu()
    return (time.perf_counter() - t0) / LOOP_FRAMES * 1e3


def child_order(spec):
    out = {"loop_before_ms": _loop_ms(spec)}
    for k in (1, 2):
        res = _main(spec, "short")
        out[f"main{k}_p50_ms"] = _p50(res["ticks"], 1)
        out[f"main{k}_ticks_ms"] = [t * 1e3 for t in res["ticks"]]
        out[f"main{k}_amortized_ms"] = res["amortized_ms"]
    out["loop_after_ms"] = _loop_ms(spec)
    return out


def child_ticks(spec, gc_mode):
    """The runner's tick loop on the long input outside main, measured
    between ticks; then the upload blocks."""
    call, carry, feeds, dev = _prepare(spec, "long")
    if gc_mode == "disable":
        gc.disable()
    elif gc_mode == "freeze":
        gc.collect()
        gc.freeze()
    cuda = dev.type == "cuda"
    out = {"gc": gc_mode, "ticks_ms": [], "gc_ms": [], "mallocs": [],
           "alloc_retries": []}
    timer = GcTimer()
    with torch.no_grad():
        for i, x in enumerate(feeds):
            g0, _ = timer.read()
            t0 = time.perf_counter()
            carry, y = call(carry, x)
            y = y.cpu().numpy()
            out["ticks_ms"].append((time.perf_counter() - t0) * 1e3)
            out["gc_ms"].append((timer.read()[0] - g0) * 1e3)
            if cuda and i < MEM_TICKS:
                m = torch.cuda.memory_stats(dev)
                out["mallocs"].append(m.get("segment.all.allocated", 0))
                out["alloc_retries"].append(m.get("num_alloc_retries", 0))
        t = out["ticks_ms"]
        out["p50_early_ms"] = float(np.median(t[1:FIRST]))
        out["p50_late_ms"] = float(np.median(t[FIRST:]))
        # the process warm: blocks of BLOCK frames, the runner's feeds on
        # the card ("card") or uploaded from host numpy ("host"), and
        # random feeds on the card ("random", the loop's), in the order
        # card, host, random, random, host, card
        rng = np.random.default_rng(271)
        inputs = {"card": [torch.from_numpy(x).to(dev)
                           for x in feeds[:BLOCK]],
                  "host": feeds[:BLOCK],
                  "random": [torch.from_numpy((rng.standard_normal(
                      x.shape) * 0.1).astype(np.float32)).to(dev)
                      for x in feeds[:BLOCK]]}
        blocks = {k: [] for k in inputs}
        for name in ("card", "host", "random", "random", "host", "card"):
            _sync(dev)
            t0 = time.perf_counter()
            for x in inputs[name]:
                carry, y = call(carry, x)
                y.cpu().numpy()
            blocks[name].append((time.perf_counter() - t0) / BLOCK * 1e3)
        out["blocks_ms"] = blocks
    timer.close()
    gc.enable()
    return out


def child_cprofile(spec):
    import cProfile

    from fastenhancer_tpu_torch.scripts import run_exported

    call, carry, feeds, _ = _prepare(spec, "long")
    prof = cProfile.Profile()
    with torch.no_grad():
        prof.enable()
        _, _, ticks = run_exported.tick_loop(call, carry, feeds)
        prof.disable()
    return dict(_profile_rows(prof, len(ticks)),
                ticks_ms=[t * 1e3 for t in ticks],
                p50_ms=_p50(ticks, 1, FIRST),
                p50_late_ms=_p50(ticks, FIRST))


def child(mode: str, spec_path: str, out_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    kind, *rest = mode.split("-")
    if kind == "order":
        res = child_order(spec)
    elif kind == "ticks":
        res = child_ticks(spec, rest[0] if rest else "on")
    elif kind == "cprofile":
        res = child_cprofile(spec)
    else:
        wav, variant = rest[0], rest[1] if len(rest) > 1 else ""
        res = {"main": child_main, "mprof": child_mprof,
               "loop": child_loop}[kind](spec, wav, variant)
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def fresh(mode: str, spec: dict, root: str) -> dict:
    """`mode` of child() on `spec` in a new Python process."""
    spec_path = os.path.join(root, f"{spec['tag']}.json")
    out_path = os.path.join(root, f"{spec['tag']}_{mode}.out.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                    mode, spec_path, "--out", out_path], cwd=REPO,
                   check=True, timeout=900)
    with open(out_path) as f:
        return json.load(f)


def _r(xs, k=1):
    return [round(x, k) for x in xs]


def report(tag: str, mode: str, r: dict, card: str) -> None:
    if mode == "order":
        line = (f"loop before main {r['loop_before_ms']:.3f} ms a frame; "
                f"main on {SHORT_SECONDS:g} s tick p50 (ticks 2 on) "
                f"{r['main1_p50_ms']:.3f}, again {r['main2_p50_ms']:.3f}; "
                f"loop after {r['loop_after_ms']:.3f}; the first main's "
                f"ticks ms {_r(r['main1_ticks_ms'])}")
    elif mode.startswith("ticks"):
        mallocs = np.diff([0] + r["mallocs"]).tolist()
        blocks = {k: _r(v, 3) for k, v in r["blocks_ms"].items()}
        line = (f"{len(r['ticks_ms'])} ticks on {LONG_SECONDS:g} s, gc "
                f"{r['gc']}: p50 ticks 2-{FIRST} {r['p50_early_ms']:.3f} ms, "
                f"ticks {FIRST + 1} on {r['p50_late_ms']:.3f}; ticks ms "
                f"{_r(r['ticks_ms'][:40])}; gc ms a tick "
                f"{_r(r['gc_ms'][:40])} (sum {sum(r['gc_ms']):.1f}); new "
                f"cudaMalloc a tick {mallocs}, alloc retries "
                f"{r['alloc_retries'][-1:]}; warm blocks, ms a frame "
                f"{blocks}")
    else:
        line = f"tick p50 (ticks 2 on) {r['p50_ms']:.3f}"
        if "p50_late_ms" in r:
            line += f" (ticks 2-{FIRST}; {FIRST + 1} on {r['p50_late_ms']:.3f})"
        line += f" ms; ticks ms {_r(r['ticks_ms'][:20])}"
        if "threads_cpu_s" in r:
            line += (f"; CPU s by thread over the loop's {r['wall_s']:.2f} s "
                     f"{r['threads_cpu_s']}; Python threads "
                     f"{r['python_threads']}; gc ms a tick "
                     f"{_r(r['gc_ms'][:15])}; the program's input flatten "
                     f"alone, ms a tick {_r(r['flatten_ms'][:15], 2)}; "
                     f"interpreter {r.get('state')}")
        if "own" in r:
            own = [(round(a, 3), round(c, 1), n) for a, _, c, n in r["own"]]
            inc = [(round(b, 3), n) for _, b, _, n in r["inclusive"]]
            line += f"; own ms a tick {own}; inclusive ms a tick {inc}"
    print(f"[{tag} {mode}] {line}; on [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(prog="tools/runner_ticks.py")
    ap.add_argument("--out", default=os.path.join(
        REPO, "logs", "runner_ticks.json"))
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--modes", default=None,
                    help="comma-separated modes for every family (default: "
                         "FIRST_MODES for the first, OTHER_MODES for the "
                         "others)")
    ap.add_argument("--child", nargs=2, metavar=("MODE", "SPEC"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child[0], args.child[1], args.out)
    if DEVICE is None and not torch.cuda.is_available():
        print("runner_ticks: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(f"{card} | torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    root = tempfile.mkdtemp(prefix="runner_ticks_")
    out = {"card": card, "streams": STREAMS, "results": {}}
    try:
        tags = args.families.split(",")
        specs = {tag: export_family(tag, root) for tag in tags}
        for k, tag in enumerate(tags):
            modes = (args.modes.split(",") if args.modes
                     else FIRST_MODES if k == 0 else OTHER_MODES)
            for mode in modes:
                r = fresh(mode, specs[tag], root)
                out["results"][f"{tag} {mode}"] = r
                report(tag, mode, r, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
