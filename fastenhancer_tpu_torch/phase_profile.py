"""Where a bfloat16 tensor-core kernel's time goes, stage by stage.

    python -m fastenhancer_tpu_torch.phase_profile

Builds a copy of `ops/csrc/` (into `ops/_build/phase_profile/`) in which
`fe::tc::run_stages` records `clock64()` of thread 0 of thread blocks 0 and
1 at five points of every weight stage: after the work that needs no weights
(`pre`: the attention before each attn_fc), after the wait for the stage's
copies, after moving them into the padded slot, after starting the next
stage's copies, and after the stage's products and the barrier behind
them. It runs the block stack (#1, default and LN form) and the whole frame
(#7) at FastEnhancer_B's shapes, 256 streams, bf16 (one thread block per
stream, all in one wave), and prints each stage's cycles at each point and
their sums per kind, beside each kernel's CUDA-event time with and without
the markers. Runs on a CUDA card only; it raises without one.

For the BSRNN stack's tensor-core form (csrc/band_tc.cuh) the markers sit
at its phases instead: thread 0 of the cluster's two blocks (the forward
and backward directions of tile 0) records the end of each layer's time
cell, the cluster barrier after it, the input projection, the W_hh copy,
the 31-step recurrence, the barrier after it and fc_freq, at BSRNN-S's
shapes, 256 streams, bf16.

The tensor-core forms of the dprnn stack (csrc/dprnn_tc.cuh, DPRNN-B) and
the dpt stack (csrc/dpt_tc.cuh, DPT-B) run on run_stages_direct, which
gets the same points but move (its copies go straight into the slots);
the dprnn sweep stage adds a point between its
input projection and its recurrence (thread 0 is lane 0 of the forward
direction's warp), and the dpt kernel marks each wait on its cache ring's
mbarriers, so the cached time attention (the `pre` of each time_fc stage)
splits into the cycles spent waiting on the ring and those computing.

The GRU scan's tensor-core form (csrc/gru_scan_tc.cuh) is marked at each
of its T steps (thread 0 of tiles 0 and 1): the products (the ldmatrix of
A included), the cell (with the wait for its x_proj loads, issued two
steps ahead), the hand-off (the next loads issued, h written to the
shared A tile, the barrier) and the ys stores; at FE-T's valid shape
(T=126, N=1024, H=20) and at FE_B's width (T=126, N=301, H=36).
Segmental RMS (csrc/segmental_rms.cu) is marked in ranks 0 and 1 of row
0's cluster: the frames' loads, the cluster barrier that gathers their
powers in rank 0, and rank 0's reduction, at the shard recipe's
[32, 64000] float32 batch. Each marker is a global read-modify-write by
thread 0, so where steps are short (the GRU scan's) the markers take a
large share of the marked time: read the split beside the time without
markers.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import typing as tp

import torch

from . import require_cuda
from .models import get_model
from .ops import _build
from .ops import bsrnn_stack as band
from .ops import dprnn_stack as dprnn
from .ops import dpt_stack as dpt
from .ops import fused_frame as frame
from .ops import gru_scan as scan
from .ops import rnnformer_stack as stack
from .ops import segmental_rms as seg
from .presets import DPRNN_B, DPT_B, FE_B, FE_T_SHARD

STREAMS = 256
POINTS = ("pre", "wait", "move", "start", "compute")
# dprnn's sweep stages: point 5 ends the input projection (before the
# recurrence, which the compute point then ends)
DPRNN_POINTS = POINTS + ("proj",)
# the dpt cache ring's wait on chunk q: code 64 + q, point 6 before it and
# 7 after it
_RING = 64
_DPRNN_MARKS = (
    ("      band_sweep_warp<kMaxHd>(t.xp, w_hh, b_hh, t.ys, g);\n",
     "FE_PROF(j, 5);", True),
)
_DPT_MARKS = (
    ("    mbar_wait(bars + q % kRing, (q / kRing) & 1);\n",
     "FE_PROF(64 + q, 6);", True),
    ("    mbar_wait(bars + q % kRing, (q / kRing) & 1);\n",
     "FE_PROF(64 + q, 7);"),
    # the end of the logits (code _PHASE + i, point 0) and of the softmax
    # (point 1) of block i's attention
    ("  // softmax of each row over the L+1 keys", "FE_PROF(120 + i, 0);",
     True),
    ("  // value mix: thread -> the channel pairs (2p, 2p + 1) of the frame's\n",
     "FE_PROF(120 + i, 1);", True),
)
_PHASE = 120
# the GRU scan's tensor-core form: the prologue (code 0, point 7), then
# each step t's points 0-3 at code t
GRU_POINTS = ("products", "cell", "hand-off and barrier", "ys store")
_GRU_MARKS = (
    ("  const int hid = a.hid, g3 = 3 * hid;\n", "FE_PROF(0, 6);"),
    ("  const size_t out_ld = static_cast<size_t>(a.rows) * hid;\n",
     "FE_PROF(0, 7);", True),
    ("    // the cell, float32\n", "FE_PROF(t, 0);", True),
    ("    if (t + 2 < a.steps) load_x(t + 2, xb);\n", "FE_PROF(t, 1);", True),
    ("    publish((t + 1) & 1);\n    __syncthreads();\n", "FE_PROF(t, 2);"),
    ("  };\n  // the time loop, unrolled by two", "    FE_PROF(t, 3);", True),
)
# segmental RMS: the loads (point 0), the cluster barrier (1), rank 0's
# reduction (2)
RMS_POINTS = ("loads", "cluster gather", "reduce")
_RMS_MARKS = (
    ("  const int rank = fe::cluster_rank();\n", "FE_PROF(0, 6);"),
    ("  fe::cluster_sync();  // every frame's power is in rank 0's pow_f\n",
     "FE_PROF(0, 0);", True),
    ("  fe::cluster_sync();  // every frame's power is in rank 0's pow_f\n",
     "FE_PROF(0, 1);"),
    ("    out[row] = fe::store_t<T>(cnt > 0.f ? sqrtf(sum / cnt) : INFINITY);"
     "\n  }\n", "FE_PROF(0, 2);"),
)
_PRE = r"""
__device__ long long fe_prof_clock[2][1024];
__device__ int fe_prof_code[2][1024];
__device__ int fe_prof_count[2];
#define FE_PROF(s, point) do { if (threadIdx.x == 0 && blockIdx.x < 2) { \
  const int k_ = fe_prof_count[blockIdx.x]++; if (k_ < 1024) { \
  fe_prof_clock[blockIdx.x][k_] = clock64(); \
  fe_prof_code[blockIdx.x][k_] = (s) * 8 + (point); } } } while (0)
"""
_POST = r"""
extern "C" int fe_prof_read(long long* clock, int* code, int* count) {
  cudaMemcpyFromSymbol(clock, fe_prof_clock, sizeof(fe_prof_clock));
  cudaMemcpyFromSymbol(code, fe_prof_code, sizeof(fe_prof_code));
  cudaMemcpyFromSymbol(count, fe_prof_count, sizeof(fe_prof_count));
  int zero[2] = {0, 0};
  return static_cast<int>(
      cudaMemcpyToSymbol(fe_prof_count, zero, sizeof(zero)));
}
"""
# (text in run_stages, the marker appended after it)
_MARKS = (
    ("      pre(s);\n", "FE_PROF(s, 0);"),
    ("      mbar_wait(bar, s & 1);\n      __syncthreads();\n",
     "FE_PROF(s, 1);"),
    ("      pieces(s, mv);\n      __syncthreads();\n", "FE_PROF(s, 2);"),
    ("      cp_async_commit();\n    }\n", "FE_PROF(s, 3);"),
    ("      compute(s, static_cast<const bf16*>(slot));\n"
     "      __syncthreads();\n", "FE_PROF(s, 4);"),
)

# the same points in run_stages_direct (the dprnn and dpt forms), which has
# no move: pre, then the next stage's copies issued (start), then the wait
# for this stage's copies, then the products
_DIRECT_MARKS = (
    ("    if (s + 1 < stages) {\n      DirectV next", "FE_PROF(s, 0);", True),
    ("    cp_async_commit();\n    cp_async_wait<1>();\n", "FE_PROF(s, 3);",
     True),
    ("    cp_async_wait<1>();\n    __syncthreads();\n", "FE_PROF(s, 1);"),
    ("    compute(s, static_cast<const bf16*>((s & 1) ? slot1 : slot0));\n"
     "    __syncthreads();\n", "FE_PROF(s, 4);"),
)

# the BSRNN tensor-core form's phases, in the order a layer runs them
BAND_PHASES = ("time cell", "barrier 1", "input proj", "W_hh copy",
               "recurrence", "barrier 2", "fc_freq")
# Finer marks: each time-cell stage of layer i at code 16 + 16 i + stage
# (point 0 its copies waited for, 2 warp 0's products, 1 its cells and
# the barrier behind them), each sweep
# step t at 128 + 32 i + t (point 0 its products, 1 its cells; the barrier
# and the next step's prefetch fall in the next products)
_CELL, _STEP = 16, 128
# (text in band_tc.cuh, the marker appended after it, or put before it
# with a third item True); code (0, 7) marks the start, before layer 0
_BAND_MARKS = (
    ("    copy_stage(st + kSlots - 1);\n", "FE_PROF(16 + 16 * i + st, 0);"),
    ("#pragma unroll\n        for (int mi = 0; mi < 2; ++mi) {\n",
     "FE_PROF(16 + 16 * i + st, 2);", True),
    ("              ra, n, xt, xt_peer, zero);\n    }\n    __syncthreads();\n",
     "FE_PROF(16 + 16 * i + st, 1);"),
    ("#pragma unroll\n      for (int e = 0; e < 4; ++e) {\n"
     "        float gate[4];\n", "FE_PROF(128 + 32 * i + t, 0);", True),
    ("        ys[static_cast<size_t>(band * kTile + s) * 2 * hd + u] = hv;\n"
     "      }\n", "FE_PROF(128 + 32 * i + t, 1);"),
    ("  cluster_sync();\n  const int r0 = q ? g.half : 0;\n",
     "FE_PROF(0, 7);"),
    ("      time_cell_chunk(a, g, i, ra, n, b0, xt, xt_peer, reg, zero);"
     "\n    }\n", "FE_PROF(i, 0);"),
    ("FE_PROF(i, 0);\n    cluster_sync();\n", "FE_PROF(i, 1);"),
    ("    input_projection(a, g, i, q, tile, xt, reg, zero);\n",
     "FE_PROF(i, 2);"),
    ("  const bool active = ug < hd / 16;\n", "FE_PROF(i, 3);"),
    ("    recurrence(a, g, i, q, tile, hb, reg, zero);\n",
     "FE_PROF(i, 4);"),
    ("    __threadfence();\n    cluster_sync();\n", "FE_PROF(i, 5);"),
    ("      fc_freq_chunk(a, g, i, tile, ra, n, xt, xt_peer, reg, zero);\n"
     "    }\n", "FE_PROF(i, 6);"),
)


def _mark(path, marks, what: str) -> None:
    text = path.read_text()
    for anchor, mark, *before in marks:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{what} changed: {anchor!r} not found once")
        text = text.replace(anchor, mark + "\n" + anchor if before
                            else anchor + mark + "\n")
    path.write_text(text)


def build() -> tp.Dict[str, ctypes.CDLL]:
    """The marked copies of rnnformer_stack.cu, fused_frame.cu,
    bsrnn_stack.cu, dprnn_stack.cu, dpt_stack.cu, gru_scan.cu and
    segmental_rms.cu."""
    dst = _build.BUILD_DIR / "phase_profile"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, dst)
    _mark(dst / "mma_common.cuh", _MARKS + _DIRECT_MARKS, "run_stages")
    _mark(dst / "band_tc.cuh", _BAND_MARKS, "band_stack_tc")
    _mark(dst / "dprnn_tc.cuh", _DPRNN_MARKS, "dprnn_stage")
    _mark(dst / "dpt_tc.cuh", _DPT_MARKS, "KvRing::wait")
    _mark(dst / "gru_scan_tc.cuh", _GRU_MARKS, "gru_tile")
    _mark(dst / "segmental_rms.cu", _RMS_MARKS, "segmental_rms_kernel")
    procs = {}
    for name in ("rnnformer_stack", "fused_frame", "bsrnn_stack",
                 "dprnn_stack", "dpt_stack", "gru_scan", "segmental_rms"):
        src = dst / f"{name}.cu"
        src.write_text(_PRE + src.read_text() + _POST)
        out = dst / f"lib{name}.so"
        procs[name] = (out, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the marked {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def read(lib: ctypes.CDLL) -> tp.List[tp.Dict[tp.Tuple[int, int], int]]:
    """{(stage, point): cycles since the mark before} for blocks 0 and 1;
    the counters are reset."""
    clock = (ctypes.c_longlong * 2048)()
    code = (ctypes.c_int * 2048)()
    count = (ctypes.c_int * 2)()
    if lib.fe_prof_read(clock, code, count):
        raise RuntimeError("reading the phase counters failed")
    out = []
    for blk in range(2):
        n = min(count[blk], 1024)
        base = 1024 * blk
        out.append({divmod(code[base + k], 8):
                    clock[base + k] - clock[base + k - 1]
                    for k in range(1, n)})
    return out


def event_ms(fn: tp.Callable[[], None], inner: int = 20) -> float:
    """Median device ms per call over 5 runs of `inner` calls, the queue
    kept ahead by a sleep kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e8))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def report(tag: str, blocks, labels: tp.Sequence[str], marked_ms: float,
           plain_ms: float, points: tp.Sequence[str] = POINTS) -> None:
    """One line per stage (block 0; block 1 in brackets where it differs
    by more than 10%), then the sums by stage kind and by point."""
    print(f"{tag}: {marked_ms:.4f} ms with the markers, {plain_ms:.4f} ms "
          f"without (CUDA events); cycles of thread block 0 (1) at "
          + ", ".join(points))
    kinds: tp.Dict[str, tp.List[int]] = {}
    for s, label in enumerate(labels):
        cells = []
        for p in range(len(points)):
            c0 = blocks[0].get((s, p), 0)
            c1 = blocks[1].get((s, p), 0)
            cells.append(f"{c0}" if abs(c1 - c0) <= 0.1 * max(c0, 1)
                         else f"{c0} ({c1})")
            kinds.setdefault(label.split(" ")[0], [0] * len(points))[p] += c0
        print(f"  {s:2d} {label:<12s} " + " ".join(f"{c:>14s}"
                                                   for c in cells))
    total = sum(sum(v) for v in kinds.values())
    print(f"  sums by kind (block 0, {total} cycles in all):")
    for kind, v in kinds.items():
        print(f"     {kind:<10s} {sum(v):>8d} ({100 * sum(v) / total:.1f}%)"
              f": " + ", ".join(f"{p} {c}" for p, c in zip(points, v)))
    by_point = [sum(v[p] for v in kinds.values()) for p in range(len(points))]
    print("  sums by point: " + ", ".join(
        f"{p} {c} ({100 * c / total:.1f}%)" for p, c in zip(points, by_point)))


def report_band(blocks, marked_ms: float, plain_ms: float) -> None:
    """One line per layer, the cycles of each phase (block 0, the forward
    direction; block 1 in brackets where it differs by more than 10%), the
    sums per phase, then the time cell's and the sweep's own split."""
    print(f"bsrnn_stack bf16 tensor-core form, BSRNN-S B={STREAMS}: "
          f"{marked_ms:.4f} ms with the markers, {plain_ms:.4f} ms without "
          "(CUDA events); cycles of thread block 0 (1) at "
          + ", ".join(BAND_PHASES))

    def phase(blk, i, p):
        out = blk.get((i, p), 0)
        if p in (0, 4):  # the time cell's stages, the sweep's steps
            lo, span = ((_CELL + 16 * i, 16) if p == 0
                        else (_STEP + 32 * i, 32))
            out += sum(v for (code, _), v in blk.items()
                       if lo <= code < lo + span)
        return out

    layers = max(c for c, p in blocks[0] if c < _CELL and p < 7) + 1
    sums = [0] * len(BAND_PHASES)
    for i in range(layers):
        cells = []
        for p in range(len(BAND_PHASES)):
            c0, c1 = phase(blocks[0], i, p), phase(blocks[1], i, p)
            sums[p] += c0
            cells.append(f"{c0}" if abs(c1 - c0) <= 0.1 * max(c0, 1)
                         else f"{c0} ({c1})")
        print(f"  layer {i} " + " ".join(f"{c:>14s}" for c in cells))
    total = sum(sums)
    print(f"  sums by phase (block 0, {total} cycles in all): " + ", ".join(
        f"{p} {c} ({100 * c / total:.1f}%)"
        for p, c in zip(BAND_PHASES, sums)))

    def split(lo, hi):
        return [sum(v for (code, p), v in blocks[0].items()
                    if lo <= code < hi and p == q) for q in (0, 1, 2)]

    wait, cells, prods = split(_CELL, _STEP)
    prod, cell, _ = split(_STEP, 1 << 30)
    print(f"  time cell stages (block 0): copies waited for {wait}, products"
          f" {prods}, cells and the barrier {cells}; sweep steps: barrier, "
          f"prefetch and products {prod}, cells {cell} "
          f"({(prod + cell) / (31 * layers):.0f} a step)")


def fold_ring(blocks, chunks: int):
    """The dpt kernel's attention marks folded into the `pre` point of the
    time_fc stage whose attention made them; returns the blocks and, for
    block 0, the attention's cycles by part: waiting on the ring, the
    logits, the softmax and the value mix with the slot write."""
    out = []
    parts = dict.fromkeys(("wait", "logits", "softmax", "mix"), 0)
    for k, blk in enumerate(blocks):
        folded = {}
        for (code, p), v in blk.items():
            if code >= _PHASE:
                key = (4 * (code - _PHASE) + 1, 0)
                part = ("logits", "softmax")[p]
            elif code >= _RING:
                q = code - _RING
                key = (4 * (q // (2 * chunks)) + 1, 0)
                is_v = q % (2 * chunks) >= chunks
                part = "wait" if p == 7 else ("mix" if is_v else "logits")
            else:
                key = (code, p)
                part = "mix" if p == 0 and code % 4 == 1 else None
            if k == 0 and part:
                parts[part] += v
            folded[key] = folded.get(key, 0) + v
        out.append(folded)
    return out, parts


def report_gru(tag: str, blocks, marked_ms: float, plain_ms: float
               ) -> None:
    """The GRU scan's cycles per step at each point (tile 0; tile 1 in
    brackets where its sum differs by more than 10%), summed over the
    steps, and the prologue."""
    steps = 1 + max(s for s, p in blocks[0] if p < 4)
    sums = [[sum(b.get((s, p), 0) for s in range(steps)) for p in range(4)]
            for b in blocks]
    total = sum(sums[0]) + blocks[0].get((0, 7), 0)
    print(f"{tag}: {marked_ms:.4f} ms with the markers, {plain_ms:.4f} ms "
          f"without (CUDA events); thread block 0, {total} cycles: prologue "
          f"{blocks[0].get((0, 7), 0)}, then {steps} steps of "
          f"{sum(sums[0]) / steps:.0f} cycles: " + ", ".join(
              f"{name} {c / steps:.0f}"
              + (f" ({c1 / steps:.0f})" if abs(c1 - c) > 0.1 * max(c, 1)
                 else "") + f" ({100 * c / max(sum(sums[0]), 1):.1f}%)"
              for name, c, c1 in zip(GRU_POINTS, sums[0], sums[1])))


def main() -> None:
    dev = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    libs = build()
    dt = torch.bfloat16
    g = torch.Generator().manual_seed(5)
    rf = FE_B["rnnformer_kwargs"]
    b, f, c, nb, heads = (STREAMS, rf["freq"], rf["channels"],
                          rf["num_blocks"], rf["num_heads"])
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(dev, dt)
            for k, s in stack.plan_shapes(nb, f, c).items()}
    x = torch.randn(b, f, c, generator=g).to(dev, dt)
    h = (torch.randn(nb, b * f, c, generator=g) * 0.5).to(dev, dt)
    block_labels = [f"{kind} {i}" for i in range(nb)
                    for kind in ("GRU", "rnn_fc", "qkv", "attn_fc")]
    fn = libs["rnnformer_stack"].rnnformer_stack_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = stack._ARGTYPES
    for ln in (False, True):
        p = dict(plan)
        if ln:
            for k in stack.LN_KEYS:
                p[k] = (torch.randn(nb, c, generator=g) * 0.2).to(dev, dt)
            p["ln_eps"] = float(rf["eps"])
        xo, ho = torch.empty_like(x), torch.empty_like(h)

        def run(p=p, xo=xo, ho=ho, ln=ln):
            wb = [p[k].data_ptr() if ln else None for k in stack.LN_KEYS]
            err = fn(x.data_ptr(), h.data_ptr(), xo.data_ptr(),
                     ho.data_ptr(), *(p[k].data_ptr() for k in stack.PLAN_KEYS),
                     *wb, b, f, c, heads, nb, p.get("ln_eps", 0.0),
                     torch.cuda.current_stream().cuda_stream)
            _build.check_launch("rnnformer_stack", err)

        run()
        torch.cuda.synchronize()
        read(libs["rnnformer_stack"])
        run()
        torch.cuda.synchronize()
        blocks = read(libs["rnnformer_stack"])
        marked = event_ms(run)
        plain = event_ms(lambda: stack.rnnformer_stack_step(p, x, h, heads))
        report(f"rnnformer_stack bf16 {'LN form' if ln else 'default'}, "
               f"FE_B B={b}", blocks, block_labels, marked, plain)

    model = get_model("fastenhancer.default", **FE_B)
    folded = model.fold(model.init(torch.Generator().manual_seed(3), dev))
    fplan = model.build_frame_plan(folded, dtype=dt)
    n_enc = len(model.kernel_size) - 1
    fx = torch.randn(b, model.freq + 1, 2 * model.stride,
                     generator=g).to(dev, dt)
    kw = dict(num_blocks=nb, num_heads=heads, n_enc=n_enc,
              enc_ks=tuple(model.kernel_size[1:]), f_enc=model.freq,
              block_freq=f, stride=model.stride, resnet=model.resnet,
              mask=model.mask_name)
    frm = [fplan[k].data_ptr() for k in frame.frame_plan_keys(n_enc)]
    stk = [fplan["stack"][k].data_ptr() for k in frame.STACK_KEYS]
    dims = [b, model.freq, f, model.channels, c, heads, nb, model.stride,
            n_enc, int(model.resnet), frame.MASKS.index(model.mask_name),
            *model.kernel_size[1:]]
    mo = torch.empty(b, model.freq, 2 * model.stride, dtype=dt, device=dev)
    fho = torch.empty_like(h)
    ffn = libs["fused_frame"].fused_frame_bf16
    ffn.restype = ctypes.c_int
    ffn.argtypes = frame._ARGTYPES

    def run_frame():
        err = ffn(fx.data_ptr(), h.data_ptr(), mo.data_ptr(), fho.data_ptr(),
                  (ctypes.c_void_p * len(frm))(*frm), len(frm),
                  (ctypes.c_void_p * len(stk))(*stk),
                  (ctypes.c_int * len(dims))(*dims), len(dims),
                  torch.cuda.current_stream().cuda_stream)
        _build.check_launch("fused_frame", err)

    run_frame()
    torch.cuda.synchronize()
    read(libs["fused_frame"])
    run_frame()
    torch.cuda.synchronize()
    blocks = read(libs["fused_frame"])
    labels = (["PreNet"] + [f"enc {i}" for i in range(n_enc)] + ["rf_pre"]
              + block_labels + ["rf_post"]
              + [f"dec_{part} {i}" for i in range(n_enc)
                 for part in ("skip", "conv")] + ["dec_post"])
    marked = event_ms(run_frame)
    plain = event_ms(lambda: frame.fused_frame_step(fplan, fx, h, **kw))
    report(f"fused_frame bf16, FE_B B={b}", blocks, labels, marked, plain)
    # a label list that does not match the stages would mislabel each row
    if max(s for s, _ in blocks[0]) != len(labels) - 1:
        raise RuntimeError("stage count differs from the labels")

    # the BSRNN stack's tensor-core form at BSRNN-S (C=64, H=128, 6 layers,
    # 31 bands)
    c, nl, bands = 64, 6, 31
    hd = 2 * c
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(dev, dt)
            for k, s in band.plan_shapes(nl, c, hd).items()}
    x = torch.randn(bands, b, c, generator=g).to(dev, dt)
    h = (torch.randn(nl, 2, bands, b, hd, generator=g) * 0.5).to(dev, dt)
    ws = band.tc_workspace(b, bands, hd, dev)
    xo, ho = torch.empty_like(x), torch.empty_like(h)
    bfn = libs["bsrnn_stack"].bsrnn_stack_tc_bf16
    bfn.restype = ctypes.c_int
    bfn.argtypes = band._TC_ARGTYPES

    def run_band():
        err = bfn(x.data_ptr(), h.data_ptr(), xo.data_ptr(), ho.data_ptr(),
                  *(plan[k].data_ptr() for k in band.PLAN_KEYS),
                  ws[0].data_ptr(), ws[1].data_ptr(), b, bands, c, hd, nl,
                  torch.cuda.current_stream().cuda_stream)
        _build.check_launch("bsrnn_stack", err)

    run_band()
    torch.cuda.synchronize()
    read(libs["bsrnn_stack"])
    run_band()
    torch.cuda.synchronize()
    blocks = read(libs["bsrnn_stack"])
    marked = event_ms(run_band)
    plain = event_ms(lambda: band.bsrnn_stack_step(plan, x, h))
    report_band(blocks, marked, plain)

    def profile(lib_name, symbol, argtypes, args, step):
        """(blocks, marked ms, plain ms) of one marked tensor-core form
        against its wrapper."""
        fn = getattr(libs[lib_name], symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes

        def run():
            err = fn(*args(), torch.cuda.current_stream().cuda_stream)
            _build.check_launch(lib_name, err)

        run()
        torch.cuda.synchronize()
        read(libs[lib_name])
        run()
        torch.cuda.synchronize()
        blocks = read(libs[lib_name])
        return blocks, event_ms(run), event_ms(step)

    # the dprnn stack's tensor-core form at DPRNN-B
    rk = DPRNN_B["dprnn_kwargs"]
    f, c, hd, nb = (rk["freq"], rk["channels"], rk["channels_frnn"],
                    rk["num_blocks"])
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(dev, dt)
            for k, s in dprnn.plan_shapes(nb, c, hd).items()}
    x = torch.randn(f, b, c, generator=g).to(dev, dt)
    h = (torch.randn(nb, f, b, c, generator=g) * 0.5).to(dev, dt)
    xo, ho = torch.empty_like(x), torch.empty_like(h)
    blocks, marked, plain = profile(
        "dprnn_stack", "dprnn_stack_tc_bf16", dprnn._ARGTYPES,
        lambda: (x.data_ptr(), h.data_ptr(), xo.data_ptr(), ho.data_ptr(),
                 *(plan[k].data_ptr() for k in dprnn.PLAN_KEYS), b, f, c,
                 hd, nb),
        lambda: dprnn.dprnn_stack_step(plan, x, h))
    labels = [f"{kind} {i}" for i in range(nb)
              for kind in ("GRU", "trnn_fc", "sweep", "frnn_fc")]
    report(f"dprnn_stack bf16 tensor-core form, DPRNN-B B={b}", blocks,
           labels, marked, plain, DPRNN_POINTS)
    sweeps = range(2, 4 * nb, 4)
    proj = sum(blocks[0].get((s, 5), 0) for s in sweeps)
    rec = sum(blocks[0].get((s, 4), 0) for s in sweeps)
    print(f"  sweep stages (block 0): input projection and its barrier "
          f"{proj}, the recurrence and the barrier behind it {rec} "
          f"({rec / (nb * f):.0f} a band step)")

    # the dpt stack's tensor-core form at DPT-B, the pointer about to wrap
    tk = DPT_B["dpt_kwargs"]
    f, c, nb, lb, heads = (tk["freq"], tk["channels"], tk["num_blocks"],
                           tk["lookbehind"], tk["num_heads"])
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(dev, dt)
            for k, s in dpt.plan_shapes(nb, f, c, heads, lb).items()}
    x = torch.randn(b, f, c, generator=g).to(dev, dt)
    shape = dpt.cache_shape(nb, b, lb, f, c)
    kc = (torch.randn(shape, generator=g) * 0.5).to(dev, dt)
    vc = (torch.randn(shape, generator=g) * 0.5).to(dev, dt)
    ptr = torch.tensor(lb - 1, dtype=torch.int32, device=dev)
    xo, po = torch.empty_like(x), torch.empty_like(ptr)
    blocks, marked, plain = profile(
        "dpt_stack", "dpt_stack_tc_bf16", dpt._ARGTYPES,
        lambda: (x.data_ptr(), kc.data_ptr(), vc.data_ptr(), ptr.data_ptr(),
                 xo.data_ptr(), po.data_ptr(),
                 *(plan[k].data_ptr() for k in dpt.PLAN_KEYS), b, f, c,
                 heads, nb, lb),
        lambda: dpt.dpt_stack_step(plan, x, kc, vc, ptr, heads))
    chunks = -(-lb // dpt.tc_chunk_slots(f, c, lb))
    blocks, parts = fold_ring(blocks, chunks)
    labels = [f"{kind} {i}" for i in range(nb)
              for kind in ("time_qkv", "time_fc", "freq_qkv", "freq_fc")]
    report(f"dpt_stack bf16 tensor-core form, DPT-B B={b} (the pre of each "
           "time_fc stage is the cached time attention)", blocks, labels,
           marked, plain)
    total = sum(parts.values())
    print(f"  cached time attention (block 0, {nb} blocks x {2 * chunks} "
          f"ring chunks, {total} cycles): " + ", ".join(
              f"{k} {v} ({100 * v / max(total, 1):.1f}%)"
              for k, v in parts.items()) + " (waiting: on the ring's "
          "mbarriers; logits and mix: computing between the waits, the "
          "barrier and the next chunk's copy issue included)")

    # the GRU scan's tensor-core form at FE-T's valid shape and at FE_B's
    # width
    valid_n = 64 * FE_T_SHARD["model_kwargs"]["rnnformer_kwargs"]["freq"]
    for t_, n, hid in ((126, valid_n, 20), (126, 301, 36)):
        gx = torch.randn(t_, n, 3 * hid, generator=g).to(dev, dt)
        gw = ((torch.rand(3 * hid, hid, generator=g) * 2 - 1)
              / hid ** 0.5).to(dev, dt)
        gb = ((torch.rand(3 * hid, generator=g) * 2 - 1)
              / hid ** 0.5).to(dev, dt)
        gh = (torch.randn(n, hid, generator=g) * 0.5).to(dev, dt)
        ys = torch.empty(t_, n, hid, dtype=dt, device=dev)
        ht = torch.empty_like(gh)
        blocks, marked, plain = profile(
            "gru_scan", "gru_scan_tc_bf16", scan._TC_ARGTYPES,
            lambda: (gx.data_ptr(), gh.data_ptr(), gw.data_ptr(),
                     gb.data_ptr(), ys.data_ptr(), ht.data_ptr(), t_, n,
                     hid),
            lambda: scan.launch_tc(gx, gh, gw, gb))
        report_gru(f"gru_scan bf16 tensor-core form, T={t_} N={n} H={hid}, "
                   f"{scan.tc_warps(hid)} warps a tile", blocks, marked,
                   plain)

    # segmental RMS at the shard recipe's train batch, float32
    wav = torch.randn(32, 64_000, generator=g).to(dev) * 0.1
    out = torch.empty(32, device=dev)
    rel, floor = seg._thresholds(-25.0, None)
    blocks, marked, plain = profile(
        "segmental_rms", "segmental_rms_f32", seg._ARGTYPES,
        lambda: (wav.data_ptr(), out.data_ptr(), 32, 64_000, 1600,
                 seg.cluster_size(32), rel, floor),
        lambda: seg.segmental_rms_fused(wav, absolute_threshold_db=None))
    print(f"segmental_rms f32 [32, 64000], a cluster of "
          f"{seg.cluster_size(32)} blocks a row: {marked:.4f} ms with the "
          f"markers, {plain:.4f} ms without (CUDA events); cycles of ranks "
          "0 (1) of row 0: " + ", ".join(
              f"{name} {blocks[0].get((0, p), 0)} "
              f"({blocks[1].get((0, p), 0)})"
              for p, name in enumerate(RMS_POINTS)))


if __name__ == "__main__":
    main()
