"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA CUDA device (`cuda` marker) and skips
without one. The file imports torch and the port only, no JAX, so it runs on
a machine without JAX; tests/conftest.py imports jax, so run it there as

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: float32 1e-5 absolute (TF32 off); bfloat16 2^-5 of the largest
magnitude (a few bf16 ulps: the kernel and cuBLAS sum in different orders,
so a sum on a rounding boundary can round either way and carry on).
"""
import ctypes

import pytest
import torch

from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.models import bsrnn as bsrnn_model
from fastenhancer_tpu_torch.models.fastenhancer import dprnn as dprnn_model
from fastenhancer_tpu_torch.models.fastenhancer import (
    dptransformer as dpt_model)
from fastenhancer_tpu_torch.ops import _build
from fastenhancer_tpu_torch.ops import bsrnn_stack as band
from fastenhancer_tpu_torch.ops import dprnn_stack as dprnn
from fastenhancer_tpu_torch.ops import dpt_stack as dpt
from fastenhancer_tpu_torch.ops import fused_frame as frame
from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.ops import rnnformer_stack as stack
from fastenhancer_tpu_torch.ops import segmental_rms as seg
from fastenhancer_tpu_torch.presets import DPRNN_B, DPT_B, FE_B, FE_T_SHARD
from fastenhancer_tpu_torch.utils import cast_floating, tree_map

pytestmark = pytest.mark.cuda

TINY_KWARGS = dict(
    channels=12, kernel_size=[4, 3], stride=4,
    rnnformer_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2),
    n_fft=128, hop_size=64, win_size=128, weight_norm=True,
    pre_post_init="linear_fixed",
)
# FastEnhancer T and S (configs/fastenhancer/{t,s}.yaml) as changes to B
FE_T = dict(FE_B, channels=24, rnnformer_kwargs=dict(
    FE_B["rnnformer_kwargs"], num_blocks=2, channels=20, freq=16))
FE_S = dict(FE_B, channels=64, kernel_size=[8, 3, 3, 3],
            rnnformer_kwargs=dict(FE_B["rnnformer_kwargs"], channels=48,
                                  freq=36))


def _close(got, want, dtype):
    want = want.float()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -5 * want.abs().max()
    assert (got.float() - want).abs().max() <= tol


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _random_case(b, f, c, nb, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(
        device, dtype) for k, s in stack.plan_shapes(nb, f, c).items()}
    x = torch.randn(b, f, c, generator=g).to(device, dtype)
    h = (torch.randn(nb, b * f, c, generator=g) * 0.5).to(device, dtype)
    return plan, x, h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,c,nb", [(256, 24, 36, 3), (8, 16, 20, 2),
                                      (8, 36, 48, 3), (3, 13, 12, 2),
                                      (5, 7, 28, 1)])
def test_stack_kernel_matches_plain(cuda_device, dtype, b, f, c, nb):
    """FE_B, FE_T and FE_S block shapes, an odd F with H=4, d=3, and an odd
    F below one 16-row tile with C a multiple of 4 but not of 8 (the bf16
    form's masked K and N edges)."""
    plan, x, h = _random_case(b, f, c, nb, dtype, cuda_device, seed=b + f)
    before = stack.rnnformer_stack_step.launches
    xo, ho = stack.rnnformer_stack_step(plan, x, h, 4)
    torch.cuda.synchronize()
    assert stack.rnnformer_stack_step.launches == before + 1
    xr, hr = stack.rnnformer_stack_reference(plan, x, h, 4)
    for got, want in ((xo, xr), (ho, hr)):
        assert got.dtype == dtype and got.device == cuda_device
        _close(got, want, dtype)


def test_stack_kernel_rejects_what_it_cannot_take(cuda_device):
    plan, x, h = _random_case(2, 8, 8, 2, torch.float16, cuda_device, seed=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stack.rnnformer_stack_step(plan, x, h, 2)
    plan, x, h = _random_case(1, 256, 64, 1, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="shared memory"):
        stack.rnnformer_stack_step(plan, x, h, 4)


def test_fused_stream_matches_unfused_on_card(cuda_device):
    """A tiny model's stream() through the kernel equals the unfused plain
    path in float32 (1e-4 on stream outputs)."""
    model = get_model("fastenhancer.default", **TINY_KWARGS)
    folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                   cuda_device))
    wav = torch.randn(3, 64 * 12, generator=torch.Generator().manual_seed(1))
    wav = (wav * 0.3).to(cuda_device)
    before = stack.rnnformer_stack_step.launches
    y_fused = model.stream(folded, wav,
                           fused_plan=model.build_stack_plan(folded))
    assert stack.rnnformer_stack_step.launches == before + 12
    y_plain = model.stream(folded, wav)
    assert (y_fused - y_plain).abs().max() <= 1e-4


def _ln_case(b, f, c, nb, dtype, device, seed):
    """A random LN-form plan: the default form's arrays and weight * bias
    terms of about 0.2, so that the quirky affine term matters."""
    plan, x, h = _random_case(b, f, c, nb, dtype, device, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for k in stack.LN_KEYS:
        plan[k] = (torch.randn(nb, c, generator=g) * 0.2).to(device, dtype)
    plan["ln_eps"] = 1e-5
    return plan, x, h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,c,nb", [(256, 24, 36, 3), (8, 8, 8, 2),
                                      (3, 13, 12, 2), (5, 7, 28, 1)])
def test_ln_stack_kernel_matches_plain(cuda_device, dtype, b, f, c, nb):
    """The LN form at LN_B's block shape, the tiny test model's, an odd F
    with H=4, d=3, and an odd F below one 16-row tile with C not a multiple
    of 8; it counts as an LN launch only."""
    plan, x, h = _ln_case(b, f, c, nb, dtype, cuda_device, seed=b + f)
    step = stack.rnnformer_stack_step
    before = (step.launches, step.ln_launches)
    xo, ho = step(plan, x, h, 4)
    torch.cuda.synchronize()
    assert (step.launches, step.ln_launches) == (before[0], before[1] + 1)
    xr, hr = stack.rnnformer_stack_reference(plan, x, h, 4)
    for got, want in ((xo, xr), (ho, hr)):
        assert got.dtype == dtype and got.device == cuda_device
        _close(got, want, dtype)


def test_ln_and_time_kernel_streams_match_unfused_on_card(cuda_device):
    """The tiny ln model's stream through the LN form and the tiny
    time_kernel model's through the default form, each against its
    unfused path on the card in float32 (1e-4 on stream outputs)."""
    tk = {k: v for k, v in TINY_KWARGS.items() if k != "kernel_size"}
    wav = torch.randn(3, 64 * 12, generator=torch.Generator().manual_seed(1))
    wav = (wav * 0.3).to(cuda_device)
    step = stack.rnnformer_stack_step
    for name, kw, counter in (
            ("fastenhancer.ln", TINY_KWARGS, "ln_launches"),
            ("fastenhancer.time_kernel", dict(tk, kernel_size_freq=[4, 3]),
             "launches")):
        model = get_model(name, **kw)
        folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                       cuda_device))
        before = getattr(step, counter)
        y_fused = model.stream(folded, wav,
                               fused_plan=model.build_stack_plan(folded))
        assert getattr(step, counter) == before + 12
        assert (y_fused - model.stream(folded, wav)).abs().max() <= 1e-4


def _dpt_case(b, f, c, nb, lb, dtype, device, seed, written):
    """A random plan, frame and cache; slots at index >= written stay zero
    (never written)."""
    g = torch.Generator().manual_seed(seed)
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(
        device, dtype)
        for k, s in dpt.plan_shapes(nb, f, c, 4, lb).items()}
    x = torch.randn(b, f, c, generator=g).to(device, dtype)
    shape = dpt.cache_shape(nb, b, lb, f, c)
    kc, vc = (torch.randn(shape, generator=g) * 0.5 for _ in range(2))
    kc[:, :, written:] = 0
    vc[:, :, written:] = 0
    return plan, x, kc.to(device, dtype), vc.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,c,nb,ptr,written", [
    (64, 24, 36, 3, 30, 31),   # DPT-B widths, the pointer about to wrap
    (8, 16, 20, 2, 0, 31),     # DPT-T
    (8, 36, 48, 3, 5, 12),     # DPT-S, slots 12.. never written
    (3, 13, 12, 2, 7, 0),      # an odd F with H=4, d=3, a cold cache
    (4, 8, 8, 1, 31 + 4, 31),  # a pointer past L is taken mod L
    (256, 24, 36, 3, 30, 31),  # DPT-B at the serving capacity, about to wrap
    (256, 24, 36, 3, 9, 0),    # DPT-B, a cold cache
    (1, 24, 36, 3, 30, 31),    # one stream
    (13, 24, 36, 3, 0, 0),     # an odd stream count, a cold cache
    (257, 16, 20, 2, 30, 31)])  # one stream past a wave of two a SM
def test_dpt_stack_kernel_matches_plain(cuda_device, dtype, b, f, c, nb, ptr,
                                        written):
    lb = 31
    plan, x, kc, vc = _dpt_case(b, f, c, nb, lb, dtype, cuda_device,
                                b + f, written)
    p = torch.tensor(ptr, dtype=torch.int32, device=cuda_device)
    kc_r, vc_r = kc.clone(), vc.clone()
    form = dpt.kernel_form(f, c, 4, lb, dtype)
    # bf16 takes the tensor-core form wherever a slot is whole 16-byte
    # chunks; the odd F=13, C=12 stays on the scalar form
    assert (form == "tc") == (dtype == torch.bfloat16 and f * c != 156)
    before = (dpt.dpt_stack_step.launches, dpt.dpt_stack_step.tc_launches)
    xo, po = dpt.dpt_stack_step(plan, x, kc, vc, p, 4)
    torch.cuda.synchronize()
    assert (dpt.dpt_stack_step.launches, dpt.dpt_stack_step.tc_launches) == (
        before[0] + 1, before[1] + (form == "tc"))
    xr, pr = dpt.dpt_stack_reference(plan, x, kc_r, vc_r, p, 4)
    assert int(po) == int(pr) == (ptr + 1) % lb and int(p) == ptr
    for got, want in ((xo, xr), (kc, kc_r), (vc, vc_r)):
        assert got.dtype == dtype and got.device == cuda_device
        _close(got, want, dtype)


def test_dpt_stack_kernel_rejects_what_it_cannot_take(cuda_device):
    plan, x, kc, vc = _dpt_case(2, 8, 8, 2, 4, torch.float16, cuda_device, 0,
                                4)
    p = torch.zeros((), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dpt.dpt_stack_step(plan, x, kc, vc, p, 4)
    plan, x, kc, vc = _dpt_case(1, 256, 64, 1, 4, torch.float32, cuda_device,
                                0, 4)
    with pytest.raises(ValueError, match="shared memory"):
        dpt.dpt_stack_step(plan, x, kc, vc, p, 4)


def _frame_case(kwargs, b, dtype, device, seed):
    model = get_model("fastenhancer.default", **kwargs)
    folded = model.fold(model.init(torch.Generator().manual_seed(seed),
                                   device))
    plan = model.build_frame_plan(folded, dtype=dtype)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(b, model.freq + 1, 2 * model.stride, generator=g)
    h = torch.randn(model.num_blocks, b * model.block_freq,
                    model.block_channels, generator=g) * 0.5
    kw = dict(num_blocks=model.num_blocks, num_heads=model.rf.num_heads,
              n_enc=len(model.kernel_size) - 1,
              enc_ks=tuple(model.kernel_size[1:]), f_enc=model.freq,
              block_freq=model.block_freq, stride=model.stride,
              resnet=model.resnet, mask=model.mask_name)
    return plan, x.to(device, dtype), h.to(device, dtype), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kwargs,b", [
    (FE_B, 64), (FE_T, 8), (FE_S, 8),
    (dict(FE_B, mask="tanh", resnet=True), 4),
    (dict(FE_B, mask="sigmoid", kernel_size=[8, 5]), 4), (FE_B, 3)],
    ids=["FE_B", "FE_T", "FE_S", "tanh-resnet", "sigmoid-k5", "FE_B-B3"])
def test_fused_frame_kernel_matches_plain(cuda_device, dtype, kwargs, b):
    plan, x, h, kw = _frame_case(kwargs, b, dtype, cuda_device, seed=b)
    before = frame.fused_frame_step.launches
    mo, ho = frame.fused_frame_step(plan, x, h, **kw)
    torch.cuda.synchronize()
    assert frame.fused_frame_step.launches == before + 1
    kw.pop("num_blocks")
    mr, hr = frame.fused_frame_reference(plan, x, h, **kw)
    for got, want in ((mo, mr), (ho, hr)):
        assert got.dtype == dtype and got.device == cuda_device
        _close(got, want, dtype)


def test_bf16_kernels_are_deterministic(cuda_device):
    """#1 (both forms), #7 and the tensor-core forms of #6 and #2 in
    bfloat16, each run twice on the same inputs, give bit-identical
    outputs: a race in the weight ring (a slot refilled while a warp still
    reads it), in #6's warp-synchronous sweep or in #2's cache ring would
    show as a run-to-run difference that a tolerance hides."""
    dt = torch.bfloat16
    for plan, x, h in (_random_case(256, 24, 36, 3, dt, cuda_device, 5),
                       _ln_case(256, 24, 36, 3, dt, cuda_device, 6)):
        first = stack.rnnformer_stack_step(plan, x, h, 4)
        second = stack.rnnformer_stack_step(plan, x, h, 4)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    plan, x, h, kw = _frame_case(FE_B, 256, dt, cuda_device, seed=7)
    first = frame.fused_frame_step(plan, x, h, **kw)
    second = frame.fused_frame_step(plan, x, h, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    plan, x, h = _dprnn_case(256, 24, 36, 3, dt, cuda_device, seed=8)
    before = dprnn.dprnn_stack_step.tc_launches
    first = dprnn.dprnn_stack_step(plan, x, h)
    second = dprnn.dprnn_stack_step(plan, x, h)
    torch.cuda.synchronize()
    assert dprnn.dprnn_stack_step.tc_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    plan, x, kc, vc = _dpt_case(256, 24, 36, 3, 31, dt, cuda_device, 9, 31)
    p = torch.tensor(30, dtype=torch.int32, device=cuda_device)
    caches = [(kc.clone(), vc.clone()) for _ in range(2)]
    before = dpt.dpt_stack_step.tc_launches
    outs = [dpt.dpt_stack_step(plan, x, k, v, p, 4) for k, v in caches]
    torch.cuda.synchronize()
    assert dpt.dpt_stack_step.tc_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert all(torch.equal(a, b) for a, b in zip(*caches))


def test_fused_frame_kernel_rejects_what_it_cannot_take(cuda_device):
    wide = dict(FE_B, channels=96, kernel_size=[8, 3, 3, 3],
                rnnformer_kwargs=dict(FE_B["rnnformer_kwargs"], channels=72,
                                      freq=48, num_blocks=1))
    plan, x, h, kw = _frame_case(wide, 1, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="shared memory"):
        frame.fused_frame_step(plan, x, h, **kw)


def test_dpt_and_frame_streams_match_unfused_on_card(cuda_device):
    """DPT-B at reduced depth through the dpt kernel over 2L+3 frames (the
    pointer wraps twice), and FE_B's whole-frame step, each against its
    unfused plain path in float32 (1e-4 on stream outputs)."""
    kw = dict(DPT_B, dpt_kwargs=dict(DPT_B["dpt_kwargs"], num_blocks=1),
              stft_method="matmul")
    model = get_model("fastenhancer.dptransformer", **kw)
    folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                   cuda_device))
    frames = 2 * model.dpt.lookbehind + 3
    wav = torch.randn(3, model.hop_size * frames,
                      generator=torch.Generator().manual_seed(1))
    wav = (wav * 0.1).to(cuda_device)
    before = dpt.dpt_stack_step.launches
    y_fused = model.stream(folded, wav,
                           fused_plan=model.build_stack_plan(folded))
    assert dpt.dpt_stack_step.launches == before + frames
    assert (y_fused - model.stream(folded, wav)).abs().max() <= 1e-4

    model = get_model("fastenhancer.default", **FE_B, stft_method="matmul")
    folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                   cuda_device))
    plan = model.build_frame_plan(folded)
    c_frame = model.init_streaming_carry(3, torch.float32, cuda_device,
                                         fused=True)
    c_plain = model.init_streaming_carry(3, torch.float32, cuda_device)
    hop = model.hop_size
    before = frame.fused_frame_step.launches
    for i in range(8):
        x = wav[:, i * hop:(i + 1) * hop]
        c_frame, y_frame = model.streaming_step_fused_frame(folded, plan,
                                                            c_frame, x)
        c_plain, y_plain = model.streaming_step(folded, c_plain, x)
        assert (y_frame - y_plain).abs().max() <= 1e-4
    assert frame.fused_frame_step.launches == before + 8


def _plan_case(shapes, c, b, x_shape, h_shape, dtype, device, seed):
    """A random plan (uniform, 1/sqrt(C) scale), frame and carries."""
    g = torch.Generator().manual_seed(seed)
    plan = {k: ((torch.rand(sh, generator=g) * 2 - 1) / c ** 0.5).to(
        device, dtype) for k, sh in shapes.items()}
    x = torch.randn(x_shape, generator=g).to(device, dtype)
    h = (torch.randn(h_shape, generator=g) * 0.5).to(device, dtype)
    return plan, x, h


def _band_case(b, c, nl, dtype, device, seed, bands=31):
    hd = 2 * c
    return _plan_case(band.plan_shapes(nl, c, hd), c, b, (bands, b, c),
                      (nl, 2, bands, b, hd), dtype, device, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,nl,bands", [
    (3, 16, 6, 31),    # BSRNN-XT widths
    (3, 64, 6, 31),    # BSRNN-S widths
    (64, 64, 2, 31),
    (2, 48, 2, 7),     # H=96: the sweep leaves 64 of 256 threads idle
    (2, 128, 1, 5)])   # H=256: each thread sweeps two units
def test_bsrnn_stack_kernel_matches_plain(cuda_device, dtype, b, c, nl,
                                          bands):
    _bsrnn_matches_plain(cuda_device, dtype, b, c, nl, bands)


def _bsrnn_matches_plain(device, dtype, b, c, nl, bands):
    """bsrnn_stack_step against the plain version; the launch is counted
    once, as the tensor-core form's exactly when kernel_form says so."""
    plan, x, h = _band_case(b, c, nl, dtype, device, seed=b + c,
                            bands=bands)
    before = band.bsrnn_stack_step.launches
    before_tc = band.bsrnn_stack_step.tc_launches
    xo, ho = band.bsrnn_stack_step(plan, x, h)
    torch.cuda.synchronize()
    assert band.bsrnn_stack_step.launches == before + 1
    tc = band.kernel_form(bands, c, 2 * c, dtype) == "tc"
    assert tc == (dtype == torch.bfloat16 and c <= 64)
    assert band.bsrnn_stack_step.tc_launches == before_tc + tc
    xr, hr = band.bsrnn_stack_reference(plan, x, h)
    for got, want in ((xo, xr), (ho, hr)):
        assert got.dtype == dtype and got.device == device
        _close(got, want, dtype)


@pytest.mark.parametrize("b,c,nl", [
    (1, 64, 2), (13, 64, 2), (257, 64, 2),  # B not a multiple of the tile
    (256, 64, 6)])                          # BSRNN-S at 256 streams
def test_bsrnn_stack_tc_form_matches_plain(cuda_device, b, c, nl):
    _bsrnn_matches_plain(cuda_device, torch.bfloat16, b, c, nl, 31)


@pytest.mark.parametrize("b,c,bands", [(21, 64, 31), (3, 16, 31),
                                       (40, 48, 7), (5, 16, 70)])
def test_bsrnn_stack_tc_form_launched_directly_matches_plain(cuda_device, b,
                                                             c, bands):
    """launch_tc with workspaces made apart from the wrapper; H = 96, and
    70 bands (three row chunks a block), among the shapes."""
    plan, x, h = _band_case(b, c, 2, torch.bfloat16, cuda_device, seed=b,
                            bands=bands)
    ws = band.tc_workspace(b, bands, 2 * c, cuda_device)
    xo, ho = band.launch_tc(plan, x, h, *ws)
    torch.cuda.synchronize()
    xr, hr = band.bsrnn_stack_reference(plan, x, h)
    for got, want in ((xo, xr), (ho, hr)):
        _close(got, want, torch.bfloat16)


def test_bsrnn_stack_tc_smem_matches_the_library(cuda_device):
    """The wrapper's shape rule counts the shared memory the kernel's
    library asks for."""
    fn = _build.function("bsrnn_stack", "bsrnn_stack_tc_smem",
                         ctypes.c_size_t, [ctypes.c_int] * 3)
    for f, c, hd in ((31, 64, 128), (31, 16, 32), (7, 48, 96), (70, 16, 32),
                     (31, 16, 128)):
        assert fn(f, c, hd) == band.tc_smem_bytes(f, c, hd)


def test_bsrnn_stack_tc_form_is_deterministic(cuda_device):
    """The tensor-core form at BSRNN-S, run twice on the same inputs, gives
    bit-identical outputs: a race between the cluster's two blocks or in
    the weight ring would show as a run-to-run difference."""
    plan, x, h = _band_case(256, 64, 6, torch.bfloat16, cuda_device, 9)
    first = band.bsrnn_stack_step(plan, x, h)
    second = band.bsrnn_stack_step(plan, x, h)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bsrnn_stack_kernel_rejects_what_it_cannot_take(cuda_device):
    plan, x, h = _band_case(2, 8, 1, torch.float16, cuda_device, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        band.bsrnn_stack_step(plan, x, h)
    plan, x, h = _band_case(2, 8, 1, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="shape"):
        band.bsrnn_stack_step(plan, x, h[:, :, :, :1].contiguous())
    plan, x, h = _band_case(1, 256, 1, torch.float32, cuda_device, 0,
                            bands=64)
    with pytest.raises(ValueError, match="shared memory"):
        band.bsrnn_stack_step(plan, x, h)


def _dprnn_case(b, f, c, nb, dtype, device, seed):
    hd = c // 2
    return _plan_case(dprnn.plan_shapes(nb, c, hd), c, b, (f, b, c),
                      (nb, f, b, c), dtype, device, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,c,nb", [(3, 24, 36, 3),    # DPRNN-B widths
                                      (3, 16, 20, 2),    # DPRNN-T
                                      (64, 24, 36, 3),
                                      (256, 24, 36, 3),  # serving capacity
                                      (1, 24, 36, 3),
                                      (13, 24, 36, 3),   # odd b: 8-byte rows
                                      (257, 16, 20, 2),
                                      (2, 8, 72, 1)])    # Hd = 36: scalar
def test_dprnn_stack_kernel_matches_plain(cuda_device, dtype, b, f, c, nb):
    plan, x, h = _dprnn_case(b, f, c, nb, dtype, cuda_device, seed=b + f)
    form = dprnn.kernel_form(f, c, c // 2, dtype)
    assert (form == "tc") == (dtype == torch.bfloat16 and c // 2 <= 32)
    before = (dprnn.dprnn_stack_step.launches,
              dprnn.dprnn_stack_step.tc_launches)
    xo, ho = dprnn.dprnn_stack_step(plan, x, h)
    torch.cuda.synchronize()
    assert (dprnn.dprnn_stack_step.launches,
            dprnn.dprnn_stack_step.tc_launches) == (
        before[0] + 1, before[1] + (form == "tc"))
    xr, hr = dprnn.dprnn_stack_reference(plan, x, h)
    for got, want in ((xo, xr), (ho, hr)):
        assert got.dtype == dtype and got.device == cuda_device
        _close(got, want, dtype)


def test_dprnn_stack_kernel_rejects_what_it_cannot_take(cuda_device):
    plan, x, h = _dprnn_case(2, 8, 8, 1, torch.float16, cuda_device, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dprnn.dprnn_stack_step(plan, x, h)
    plan, x, h = _dprnn_case(2, 8, 8, 1, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="shape"):
        dprnn.dprnn_stack_step(plan, x, h[:, :, :1].contiguous())
    plan, x, h = _dprnn_case(1, 256, 64, 1, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="shared memory"):
        dprnn.dprnn_stack_step(plan, x, h)


def test_bsrnn_and_dprnn_streams_match_unfused_on_card(cuda_device):
    """Each model at full width and reduced depth through its kernel over 6
    frames of 3 streams, against its unfused plain path in float32 (1e-4 on
    stream outputs)."""
    for name, kw, counter in (
            ("bsrnn", dict(num_channels=64, num_layers=2),
             band.bsrnn_stack_step),
            ("fastenhancer.dprnn",
             dict(DPRNN_B, dprnn_kwargs=dict(DPRNN_B["dprnn_kwargs"],
                                             num_blocks=1)),
             dprnn.dprnn_stack_step)):
        model = get_model(name, **kw, stft_method="matmul")
        folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                       cuda_device))
        wav = torch.randn(3, model.hop_size * 6,
                          generator=torch.Generator().manual_seed(1))
        wav = (wav * 0.1).to(cuda_device)
        before = counter.launches
        y_fused = model.stream(folded, wav,
                               fused_plan=model.build_stack_plan(folded))
        assert counter.launches == before + 6
        assert (y_fused - model.stream(folded, wav)).abs().max() <= 1e-4


def test_dprnn_and_dpt_tc_forms_match_the_library_and_the_scalar_form(
        cuda_device):
    """Each tensor-core form's shared memory as its library computes it
    equals the wrapper's count; at DPRNN-B and DPT-B in bf16 both forms,
    launched directly, match the plain version."""
    size = _build.function("dprnn_stack", "dprnn_stack_smem_bf16",
                           ctypes.c_size_t, [ctypes.c_int] * 3)
    for f, c, hd in ((24, 36, 18), (16, 20, 10), (36, 48, 24), (5, 12, 32)):
        assert size(f, c, hd) == dprnn.tc_smem_bytes(f, c, hd)
    size = _build.function("dpt_stack", "dpt_stack_smem_bf16",
                           ctypes.c_size_t, [ctypes.c_int] * 4)
    for f, c, lb in ((24, 36, 31), (16, 20, 31), (36, 48, 31), (8, 8, 5)):
        assert size(f, c, 4, lb) == dpt.tc_smem_bytes(f, c, 4, lb)
    dt = torch.bfloat16
    plan, x, h = _dprnn_case(21, 24, 36, 3, dt, cuda_device, seed=3)
    want = dprnn.dprnn_stack_reference(plan, x, h)
    for launch in (dprnn.launch_tc, dprnn.launch_scalar):
        for got, ref in zip(launch(plan, x, h), want):
            _close(got, ref, dt)
    plan, x, kc, vc = _dpt_case(21, 24, 36, 3, 31, dt, cuda_device, 4, 20)
    p = torch.tensor(25, dtype=torch.int32, device=cuda_device)
    kr, vr = kc.clone(), vc.clone()
    xr, _ = dpt.dpt_stack_reference(plan, x, kr, vr, p, 4)
    for launch in (dpt.launch_tc, dpt.launch_scalar):
        k, v = kc.clone(), vc.clone()
        xo, po = launch(plan, x, k, v, p, 4)
        torch.cuda.synchronize()
        assert int(po) == 26
        for got, ref in ((xo, xr), (k, kr), (v, vr)):
            _close(got, ref, dt)


def test_dprnn_and_dpt_bf16_streams_run_the_tc_forms_on_card(cuda_device,
                                                             monkeypatch):
    """DPRNN-B and DPT-B at full width and reduced depth, bf16, over frames
    of 3 streams through each kernel's tensor-core form (DPT-B over 2L+3
    frames, so the pointer wraps twice), against the same fused stream with
    the plain version in the kernel's place (2^-5 of the peak, the file's
    bf16 tolerance)."""
    for name, kw, module, attr, op, frames in (
            ("fastenhancer.dprnn",
             dict(DPRNN_B, dprnn_kwargs=dict(DPRNN_B["dprnn_kwargs"],
                                             num_blocks=1)),
             dprnn_model, "dprnn_stack_step", dprnn, 6),
            ("fastenhancer.dptransformer",
             dict(DPT_B, dpt_kwargs=dict(DPT_B["dpt_kwargs"], num_blocks=1)),
             dpt_model, "dpt_stack_step", dpt, 65)):
        model = get_model(name, **kw, stft_method="matmul")
        folded = cast_floating(model.fold(model.init(
            torch.Generator().manual_seed(0), cuda_device)), torch.bfloat16)
        plan = model.build_stack_plan(folded)
        wav = torch.randn(3, model.hop_size * frames,
                          generator=torch.Generator().manual_seed(1))
        wav = (wav * 0.1).to(cuda_device, torch.bfloat16)
        step = getattr(module, attr)
        before = step.tc_launches
        y_kernel = model.stream(folded, wav, fused_plan=plan)
        assert step.tc_launches == before + frames
        with monkeypatch.context() as m:
            m.setattr(module, attr, getattr(op, attr.replace(
                "_step", "_reference")))
            y_plain = model.stream(folded, wav, fused_plan=plan)
        _close(y_kernel, y_plain, torch.bfloat16)


def test_bsrnn_bf16_stream_runs_the_tc_form_on_card(cuda_device,
                                                    monkeypatch):
    """BSRNN at full width and reduced depth, bf16, over 6 frames of 3
    streams through the tensor-core form, against the same fused stream
    with the plain version in the kernel's place (2^-5 of the peak, the
    file's bf16 tolerance)."""
    model = get_model("bsrnn", num_channels=64, num_layers=2,
                      stft_method="matmul")
    folded = cast_floating(model.fold(model.init(
        torch.Generator().manual_seed(0), cuda_device)), torch.bfloat16)
    plan = model.build_stack_plan(folded)
    wav = torch.randn(3, model.hop_size * 6,
                      generator=torch.Generator().manual_seed(1))
    wav = (wav * 0.1).to(cuda_device, torch.bfloat16)
    before = band.bsrnn_stack_step.tc_launches
    y_kernel = model.stream(folded, wav, fused_plan=plan)
    assert band.bsrnn_stack_step.tc_launches == before + 6
    monkeypatch.setattr(bsrnn_model, "bsrnn_stack_step",
                        band.bsrnn_stack_reference)
    y_plain = model.stream(folded, wav, fused_plan=plan)
    _close(y_kernel, y_plain, torch.bfloat16)


def _rms_rows(b, t, seed):
    """b rows at -20 dB, row 1 silent, row 2 60 dB quieter in its first
    half, row 3 at -60 dB throughout (those that b has)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, generator=g) * 0.1
    x[1:2] = 0.0
    x[2:3, : t // 2] *= 1e-3
    x[3:4] *= 1e-2
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,abs_db", [
    (32, 64_000, None),       # the shard recipe's train batch, no floor
    (32, 64_000, -50.0),
    (5, 5 * 1600 + 700, -50.0),  # T not a multiple of the window
    (4, 1300, -50.0)])        # T shorter than one window
def test_segmental_rms_kernel_matches_plain(cuda_device, dtype, b, t, abs_db):
    x = _rms_rows(b, t, seed=t).to(cuda_device, dtype)
    before = seg.segmental_rms_fused.launches
    got = seg.segmental_rms_fused(x[:, None], absolute_threshold_db=abs_db)
    torch.cuda.synchronize()
    assert seg.segmental_rms_fused.launches == before + 1
    want = seg.segmental_rms(x, absolute_threshold_db=abs_db)
    assert got.dtype == dtype and got.shape == (b, 1, 1)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float()[fin] - want.float()[fin]).abs()
    assert (err <= rel * want.float()[fin].abs()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 5, 32, 200])
@pytest.mark.parametrize("t", [1300, 8700, 64_000, 64_003])
def test_segmental_rms_cluster_form_matches_plain(cuda_device, dtype, b, t):
    """The cluster of cluster_size(B) blocks a row (8 at B = 1 and 5, 4 at
    32, 1 at 200), T shorter than a frame, not a multiple of the frame,
    and rows that do not start on 16 bytes (T = 64003): +inf where the
    plain version has it, each finite value within 1e-5 (float32) or 2^-7
    (bfloat16) relative."""
    x = _rms_rows(b, t, seed=b + t).to(cuda_device, dtype)
    got = seg.segmental_rms_fused(x, absolute_threshold_db=-50.0)
    torch.cuda.synchronize()
    want = seg.segmental_rms(x, absolute_threshold_db=-50.0)
    assert got.dtype == dtype and got.shape == (b, 1, 1)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    if t >= 1600 and b > 1:
        assert torch.isinf(want[1]).all()  # the silent row
    fin = torch.isfinite(want)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float()[fin] - want.float()[fin]).abs()
    assert (err <= rel * want.float()[fin].abs()).all()


def _scan_case(t, n, h, dtype, device, seed, h0=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, n, 3 * h, generator=g)
    w = (torch.rand(3 * h, h, generator=g) * 2 - 1) / h ** 0.5
    b = (torch.rand(3 * h, generator=g) * 2 - 1) / h ** 0.5
    hh = torch.randn(n, h, generator=g) * 0.5 if h0 else torch.zeros(n, h)
    return [a.to(device, dtype) for a in (x, hh, w, b)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,h,h0", [
    (126, 1024, 20, False),   # the shard recipe's valid forward (FE-T)
    (13, 37, 20, True),       # N not a multiple of the tile
    (126, 300, 36, True),     # FE-B's width
    (13, 5, 128, True)])      # the widest H the kernel takes
def test_gru_scan_kernel_matches_plain(cuda_device, dtype, t, n, h, h0):
    args = _scan_case(t, n, h, dtype, cuda_device, seed=t + n, h0=h0)
    before = scan.gru_scan.launches
    ys, h_t = scan.gru_scan(*args)
    torch.cuda.synchronize()
    assert scan.gru_scan.launches == before + 1
    ys_r, h_r = scan.gru_scan_reference(*args)
    for got, want in ((ys, ys_r), (h_t, h_r)):
        assert got.dtype == dtype and got.device == cuda_device
        _close(got, want, dtype)


def test_gru_scan_kernel_rejects_what_it_cannot_take(cuda_device):
    args = _scan_case(3, 4, 8, torch.float32, cuda_device, 0)
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="backward"):
        scan.gru_scan(*args)
    with torch.no_grad():
        scan.gru_scan(*args)  # no graph to build: fine
    with pytest.raises(ValueError, match="H <= 128"):
        scan.gru_scan(*_scan_case(2, 3, 130, torch.float32, cuda_device, 0))
    args = _scan_case(2, 3, 8, torch.float16, cuda_device, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scan.gru_scan(*args)


@pytest.mark.parametrize("h0", [True, False])
@pytest.mark.parametrize("h", [18, 20, 36, 64, 128])
@pytest.mark.parametrize("n", [5, 37, 301, 1024])
@pytest.mark.parametrize("t", [0, 1, 13, 126])
def test_gru_scan_tc_form_matches_plain(cuda_device, t, n, h, h0):
    """bfloat16 runs the tensor-core form (a tile of 16 rows a block; N
    ragged, H not a multiple of 8 or 16, W_hh's fragments in registers up
    to H = 64 and in shared memory above), within BF16_REL of the peak."""
    args = _scan_case(t, n, h, torch.bfloat16, cuda_device, seed=t + n + h,
                      h0=h0)
    assert scan.kernel_form(n, h, torch.bfloat16) == "tc"
    before, before_tc = scan.gru_scan.launches, scan.gru_scan.tc_launches
    ys, h_t = scan.gru_scan(*args)
    torch.cuda.synchronize()
    assert scan.gru_scan.launches == before + 1
    assert scan.gru_scan.tc_launches == before_tc + 1
    ys_r, h_r = scan.gru_scan_reference(*args)
    assert ys.shape == ys_r.shape and h_t.shape == h_r.shape
    err = (h_t.float() - h_r.float()).abs().max().item()
    print(f"gru_scan tc T={t} N={n} H={h} h0={h0}: h_T max abs err {err:.3e}")
    if t:
        _close(ys, ys_r, torch.bfloat16)
    _close(h_t, h_r, torch.bfloat16)


def test_gru_scan_tc_form_is_deterministic_and_takes_a_misaligned_x_proj(
        cuda_device):
    """Two launches give the same bits; an x_proj view that starts off a
    4-byte boundary (the kernel reads bf16 pairs) gives them too."""
    args = _scan_case(126, 301, 20, torch.bfloat16, cuda_device, seed=3)
    ys, h_t = scan.launch_tc(*args)
    ys_2, h_2 = scan.launch_tc(*args)
    buf = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)
    buf[1:] = args[0].flatten()
    shifted = buf[1:].view(args[0].shape)
    assert shifted.data_ptr() % 4
    ys_3, h_3 = scan.launch_tc(shifted, *args[1:])
    torch.cuda.synchronize()
    for got, want in ((ys_2, ys), (h_2, h_t), (ys_3, ys), (h_3, h_t)):
        assert torch.equal(got, want)


def test_gru_scan_tc_smem_matches_the_library(cuda_device):
    size = _build.function("gru_scan", "gru_scan_tc_smem", ctypes.c_longlong,
                           [ctypes.c_int])
    for h in (2, 8, 18, 20, 36, 64, 66, 100, 128):
        assert size(h) == scan.tc_smem_bytes(h)


def test_gru_scan_forms_and_tc_launches_agree(cuda_device):
    """kernel_form's choice is the form that runs: float32 and odd H count
    a launch and no tc launch, bfloat16 at even H both; launch_tc refuses
    float32 and H > 128, and counts nothing."""
    for dtype, h, tc in ((torch.float32, 20, 0), (torch.bfloat16, 20, 1),
                         (torch.bfloat16, 21, 0)):
        args = _scan_case(13, 37, h, dtype, cuda_device, 1)
        before, before_tc = scan.gru_scan.launches, scan.gru_scan.tc_launches
        ys, h_t = scan.gru_scan(*args)
        torch.cuda.synchronize()
        assert scan.gru_scan.launches == before + 1
        assert scan.gru_scan.tc_launches == before_tc + tc
        assert (scan.kernel_form(37, h, dtype) == "tc") == bool(tc)
        ys_r, h_r = scan.gru_scan_reference(*args)
        _close(ys, ys_r, dtype)
        _close(h_t, h_r, dtype)
    with pytest.raises(ValueError, match="tensor-core form"):
        scan.launch_tc(*_scan_case(3, 4, 20, torch.float32, cuda_device, 0))
    with pytest.raises(ValueError, match="tensor-core form"):
        scan.launch_tc(*_scan_case(3, 4, 130, torch.bfloat16, cuda_device,
                                   0))
    before_tc = scan.gru_scan.tc_launches
    scan.launch_tc(*_scan_case(3, 4, 20, torch.bfloat16, cuda_device, 0))
    assert scan.gru_scan.tc_launches == before_tc


def test_fe_t_offline_forward_on_card_matches_cpu(cuda_device):
    """FE-T's eval forward (each block's time GRU one gru_scan launch) on
    the card against the same forward on the CPU's plain path, float32
    (1e-4 on the wav, after the iSTFT)."""
    kw = FE_T_SHARD["model_kwargs"]
    model = get_model("fastenhancer.default", **kw)
    variables = model.init(torch.Generator().manual_seed(0), "cpu")
    wav = torch.randn(4, 16_000, generator=torch.Generator().manual_seed(1))
    want, _, _ = model.forward(variables, wav * 0.1)
    dev = tree_map(lambda a: a.to(cuda_device), variables)
    before = scan.gru_scan.launches
    got, _, _ = model.forward(dev, (wav * 0.1).to(cuda_device))
    assert scan.gru_scan.launches == before + 2
    assert (got.cpu() - want).abs().max() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0", [True, False])
@pytest.mark.parametrize("n", [6144, 6143])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_gru_scan_matches_plain_at_chunked_fe_b_shapes(cuda_device, dtype,
                                                       t, n, h0):
    """FE_B's chunked stream at 256 streams: a chunk of T frames over
    N = 256 * 24 rows (a full tile tail and a ragged one), H = 36, from a
    carried bf16 or float32 state; bfloat16 runs the tensor-core form."""
    args = _scan_case(t, n, 36, dtype, cuda_device, seed=t + n, h0=h0)
    before_tc = scan.gru_scan.tc_launches
    ys, h_t = scan.gru_scan(*args)
    torch.cuda.synchronize()
    assert scan.gru_scan.tc_launches == before_tc + (dtype == torch.bfloat16)
    ys_r, h_r = scan.gru_scan_reference(*args)
    _close(ys, ys_r, dtype)
    _close(h_t, h_r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 4])
def test_gru_scan_matches_plain_at_the_noncausal_width(cuda_device, dtype,
                                                       b):
    """The huge noncausal recipe's time GRU: T = 640 frames, N = B * 64
    rows, H = 128 (W_hh's fragments in shared memory in the tensor-core
    form), both directions: the forward scan and the backward one over the
    time-flipped x_proj, each against its plain version."""
    x, h0, w, bias = _scan_case(640, b * 64, 128, dtype, cuda_device,
                                seed=b, h0=False)
    for xp in (x, x.flip(0)):
        ys, h_t = scan.gru_scan(xp, h0, w, bias)
        torch.cuda.synchronize()
        ys_r, h_r = scan.gru_scan_reference(xp, h0, w, bias)
        _close(ys, ys_r, dtype)
        _close(h_t, h_r, dtype)


@pytest.mark.parametrize("name,kwargs", [
    ("fastenhancer.default", TINY_KWARGS),
    ("fastenhancer.ln", TINY_KWARGS),
    ("fastenhancer.dprnn",
     dict(DPRNN_B, dprnn_kwargs=dict(DPRNN_B["dprnn_kwargs"], num_blocks=1))),
    ("fastenhancer.dptransformer",
     dict(DPT_B, dpt_kwargs=dict(DPT_B["dpt_kwargs"], num_blocks=1))),
    ("bsrnn", dict(num_channels=64, num_layers=2))],
    ids=["default", "ln", "dprnn", "dpt", "bsrnn"])
def test_chunked_streams_on_card_match_per_frame(cuda_device, name, kwargs):
    """stream(chunk_frames=4) on the card over 10 frames of 3 streams (the
    tail cut to 8), float32, against the per-frame unfused stream on the
    card (1e-4 on stream outputs); each block's time GRU is one gru_scan
    launch a chunk."""
    model = get_model(name, **kwargs, stft_method="matmul")
    folded = model.fold(model.init(torch.Generator().manual_seed(0),
                                   cuda_device))
    wav = torch.randn(3, model.hop_size * 10,
                      generator=torch.Generator().manual_seed(1))
    wav = (wav * 0.1).to(cuda_device)
    before = scan.gru_scan.launches
    y = model.stream(folded, wav, chunk_frames=4)
    gru_blocks = 0 if name in ("bsrnn", "fastenhancer.dptransformer") \
        else model.num_blocks
    assert scan.gru_scan.launches == before + 2 * gru_blocks
    assert y.shape == (3, model.hop_size * 8)
    want = model.stream(folded, wav)[:, :y.shape[1]]
    assert (y - want).abs().max() <= 1e-4


def test_noncausal_forward_on_card_matches_cpu(cuda_device):
    """The noncausal model at the huge recipe's widths and 2 of its 6
    blocks: its eval forward on the card (each block's biGRU two gru_scan
    launches) against the CPU's plain path, float32 (1e-4 on the wav);
    in bf16 every launch is the tensor-core form at H = 128."""
    from fastenhancer_tpu_torch.presets import NONCAUSAL_HUGE

    kw = dict(NONCAUSAL_HUGE, rnnformer_kwargs=dict(
        NONCAUSAL_HUGE["rnnformer_kwargs"], num_blocks=2))
    model = get_model("fastenhancer.noncausal", **kw)
    variables = model.init(torch.Generator().manual_seed(0), "cpu")
    wav = torch.randn(2, 8_000, generator=torch.Generator().manual_seed(1))
    want, _, _ = model.forward(variables, wav * 0.1)
    dev = tree_map(lambda a: a.to(cuda_device), variables)
    before = scan.gru_scan.launches
    got, _, _ = model.forward(dev, (wav * 0.1).to(cuda_device))
    assert scan.gru_scan.launches == before + 4
    assert (got.cpu() - want).abs().max() <= 1e-4
    before_tc = scan.gru_scan.tc_launches
    model.forward(cast_floating(dev, torch.bfloat16),
                  (wav * 0.1).to(cuda_device, torch.bfloat16))
    assert scan.gru_scan.tc_launches == before_tc + 4


# the baselines' #5 shapes (T, N, H, h0, both directions), at 256 streams
# (a frame, a chunk of 4) and offline over 4 x 4 s (251 frames)
BASELINE_SCANS = [
    (32, 256, 16, False, True),    # FSPEN's intra biGRU, a frame
    (32, 1024, 16, False, True),   # ... a chunk of 4
    (32, 1004, 16, False, True),   # ... offline: N = 251 frames x 4
    (1, 1024, 16, True, False),    # a group's time GRU, a frame: 256 x 4
    (4, 1024, 16, True, False),    # ... a chunk of 4
    (251, 16, 16, False, False),   # ... offline: one tile of 16 rows
    (32, 256, 12, False, True),    # LiSenNet's intra biGRU, a frame
    (32, 1024, 12, False, True),   # ... a chunk of 4
    (32, 1004, 12, False, True),   # ... offline
    (1, 8192, 24, True, False),    # its time GRU, a frame: 256 x 32
    (4, 8192, 24, True, False),    # ... a chunk of 4
    (4, 8191, 24, True, False),    # ... the tile tail ragged
    (251, 128, 24, False, False),  # ... offline
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,h,h0,both", BASELINE_SCANS)
def test_gru_scan_matches_plain_at_the_baselines_shapes(cuda_device, dtype,
                                                        t, n, h, h0, both):
    """FSPEN's and LiSenNet's GRUs: H = 12 and 24 pad their k-steps (not
    multiples of 16), the intra biGRUs fill few SMs, FSPEN's offline time
    GRU is one tile over 251 steps; an intra biGRU's backward direction
    runs over the time-flipped x_proj. bfloat16 runs the tensor-core form."""
    x, hh, w, bias = _scan_case(t, n, h, dtype, cuda_device, seed=t + n + h,
                                h0=h0)
    for xp in (x, x.flip(0)) if both else (x,):
        before_tc = scan.gru_scan.tc_launches
        ys, h_t = scan.gru_scan(xp, hh, w, bias)
        torch.cuda.synchronize()
        assert scan.gru_scan.tc_launches == before_tc + (dtype ==
                                                         torch.bfloat16)
        ys_r, h_r = scan.gru_scan_reference(xp, hh, w, bias)
        _close(ys, ys_r, dtype)
        _close(h_t, h_r, dtype)


@pytest.mark.parametrize("name,kwargs,per_chunk", [
    ("fspen", dict(dpe_kwargs=dict(num_blocks=1)), 10),
    ("lisennet", dict(n_blocks=1), 3)])
def test_baseline_streams_on_card_match_cpu(cuda_device, name, kwargs,
                                            per_chunk):
    """FSPEN (one block of 8 groups) and LiSenNet (one block), float32:
    stream(chunk_frames=4) over 10 frames of 3 streams (the tail cut to 8)
    on the card against the same stream on the CPU's plain path and
    against the per-frame stream on the card (1e-4 on stream outputs);
    every GRU is one gru_scan launch a chunk (FSPEN 2 + 8, LiSenNet 2 + 1),
    and in bf16 all of them the tensor-core form."""
    model = get_model(name, **kwargs, stft_method="matmul")
    variables = model.fold(model.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    wav = torch.randn(3, model.hop_size * 10,
                      generator=torch.Generator().manual_seed(1)) * 0.1
    want = model.stream(variables, wav, chunk_frames=4)
    dev = tree_map(lambda a: a.to(cuda_device), variables)
    before = scan.gru_scan.launches
    y = model.stream(dev, wav.to(cuda_device), chunk_frames=4)
    assert scan.gru_scan.launches == before + 2 * per_chunk
    assert (y.cpu() - want).abs().max() <= 1e-4
    frames = model.stream(dev, wav.to(cuda_device))[:, :y.shape[1]]
    assert (y - frames).abs().max() <= 1e-4
    before_tc = scan.gru_scan.tc_launches
    model.stream(cast_floating(dev, torch.bfloat16),
                 wav.to(cuda_device, torch.bfloat16), chunk_frames=4)
    assert scan.gru_scan.tc_launches == before_tc + 2 * per_chunk


@pytest.mark.parametrize("t,n", [(257, 64), (129, 16), (161, 63)])
def test_gru_scan_scalar_form_at_the_pesq_forward_shapes(cuda_device, t, n):
    """#5 in float32 at the PESQ forward's shapes (FE-T's time GRU, H = 20,
    N = rows x 16 bins, T = a 16-hop-padded file's frames, a ragged N): the
    scalar form, against the plain version."""
    args = _scan_case(t, n, 20, torch.float32, cuda_device, seed=t + n)
    assert scan.kernel_form(n, 20, torch.float32) == "scalar"
    before = (scan.gru_scan.launches, scan.gru_scan.tc_launches)
    ys, h_t = scan.gru_scan(*args)
    torch.cuda.synchronize()
    assert (scan.gru_scan.launches, scan.gru_scan.tc_launches) == (
        before[0] + 1, before[1])
    ys_r, h_r = scan.gru_scan_reference(*args)
    _close(ys, ys_r, torch.float32)
    _close(h_t, h_r, torch.float32)


def test_checkpoint_round_trip_on_card_binds_the_live_leaves(cuda_device,
                                                             tmp_path):
    """A float32 `ns` wrapper on the card trains 2 steps and saves; another
    (another seed) loads: params, BN statistics, m, v, step and scheduler
    equal bit for bit, the optimizer holds the wrapper's live leaves, and
    a step on both agrees (to 1e-6: the card's backward may sum with
    atomics, in any order)."""
    import copy

    from fastenhancer_tpu_torch.utils import tree_paths
    from fastenhancer_tpu_torch.utils.hparams import HParams
    from fastenhancer_tpu_torch.wrappers import get_wrapper

    def wrapper(seed):
        hps = copy.deepcopy(FE_T_SHARD)
        hps["model_kwargs"] = dict(TINY_KWARGS)
        hps["wrapper"] = "ns"
        hps["train"].update(fp16=False, seed=seed)
        hps["base_dir"] = str(tmp_path)
        return get_wrapper("ns")(HParams(**hps), train=True,
                                 device=cuda_device)

    def batch(seed):
        g = torch.Generator().manual_seed(seed)
        clean = (torch.randn(3, 64 * 12, generator=g) * 0.1).numpy()
        return {"clean": clean, "noisy": clean * 1.5}

    def state(w):
        v = w.state["variables"]
        return ({p: t.cpu() for p, t in tree_paths(v["params"])},
                {p: t.cpu() for p, t in tree_paths(v["stats"])},
                {p: torch.from_numpy(a) for p, a in tree_paths(
                    w.optim.state_tree(v["params"]))},
                w.scheduler.state_dict())

    a = wrapper(1)
    a.train_epoch([batch(0), batch(1)])
    a.save(1)
    b = wrapper(7)
    assert b.load() and b.epoch == 1
    sa, sb = state(a), state(b)
    for x, y in zip(sa[:3], sb[:3]):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert sa[3] == sb[3]
    leaves = {id(t) for _, t in tree_paths(b.state["variables"]["params"])}
    assert all(id(p) in leaves and p.device == cuda_device
               for g in b.optim.param_groups for p in g["params"])
    a.train_epoch([batch(2)])
    b.train_epoch([batch(2)])
    sa, sb = state(a), state(b)
    for x, y in zip(sa[:3], sb[:3]):
        assert all((x[k].float() - y[k].float()).abs().max() <= 1e-6
                   for k in x)
