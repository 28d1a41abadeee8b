"""ops/gru_scan.py (kernel 5's plain version and its CPU wrapper) against
the JAX package's Pallas kernel `gru_scan_pallas` and its drop-in
`gru_pallas`, both in interpret mode as tests/test_ops_pallas.py runs them;
and the arithmetic of the kernel's tensor-core form (csrc/gru_scan_tc.cuh),
rendered in plain torch, against both, with its form choice and geometry.

Tolerances: float32 1e-5 (T steps of recurrence at unit scale); bfloat16
one bf16 ulp of the largest magnitude (2^-7): both round only ys and h_T,
so the float32 states differ only by the order of their sums (and, for
the tensor-core form, by the 2^-17 relative that the hi/lo split of the
state leaves off each product).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.nn.gru import init_gru as jinit_gru
from fastenhancer_tpu.nn.layers import to_wn as jto_wn
from fastenhancer_tpu.ops.gru_scan import gru_pallas, gru_scan_pallas
from fastenhancer_tpu_torch import nn as fnn
from fastenhancer_tpu_torch import presets
from fastenhancer_tpu_torch.ops import _build
from fastenhancer_tpu_torch.ops import gru_scan as scan
from fastenhancer_tpu_torch.ops.gru_scan import (gru_fused, gru_scan,
                                                 gru_scan_reference)
from fastenhancer_tpu_torch.utils import from_jax

from _torch_parity import to_np_tree, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _case(t, n, h, seed, h0=True):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((t, n, 3 * h)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (3 * h, h)) / h ** 0.5).astype(np.float32)
    b_hh = (rng.uniform(-1, 1, 3 * h) / h ** 0.5).astype(np.float32)
    hh = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    return x_proj, (hh if h0 else np.zeros((n, h), np.float32)), w_hh, b_hh


@pytest.mark.parametrize("t,n,h,h0", [(13, 37, 20, True), (13, 37, 20, False),
                                      (126, 10, 36, True), (5, 3, 18, True)])
def test_scan_matches_pallas(t, n, h, h0):
    """N not a multiple of the Pallas tile, T not of its time chunk."""
    arrs = _case(t, n, h, t + n, h0)
    ys_j, ht_j = gru_scan_pallas(*map(jnp.asarray, arrs), interpret=True)
    ys_t, ht_t = gru_scan(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(ht_t.numpy(), np.asarray(ht_j), atol=1e-5)


def test_scan_bfloat16_cast_points():
    """bf16 operands: the state stays float32 over the 13 steps and only
    ys and h_T are rounded, as in the Pallas kernel."""
    arrs = [a.astype(jnp.bfloat16) for a in map(jnp.asarray,
                                                  _case(13, 37, 20, 3))]
    ys_j, ht_j = gru_scan_pallas(*arrs, interpret=True)
    targs = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
             for a in arrs]
    ys_t, ht_t = gru_scan(*targs)
    assert ys_t.dtype == ht_t.dtype == torch.bfloat16
    ys_j = np.asarray(ys_j, np.float32)
    tol = 2 ** -7 * np.abs(ys_j).max()
    assert np.abs(ys_t.float().numpy() - ys_j).max() <= tol
    np.testing.assert_allclose(ht_t.float().numpy(), np.asarray(ht_j,
                                                                np.float32),
                               atol=tol)
    # the state is not rounded between steps: equal to the float32 run
    # rounded once at the end
    ys_f, _ = gru_scan_reference(*[a.float() for a in targs])
    np.testing.assert_array_equal(ys_t.float().numpy(),
                                  ys_f.bfloat16().float().numpy())


def test_fused_matches_gru_pallas_with_weight_norm():
    key = jax.random.PRNGKey(2)
    p = jinit_gru(key, 12, 20)
    p["weight_ih"] = jto_wn(p["weight_ih"])
    p["weight_hh"] = jto_wn(p["weight_hh"])
    p["weight_hh"]["g"] = p["weight_hh"]["g"] * 1.7  # g != ||v||
    x = np.random.default_rng(4).standard_normal((13, 9, 12)).astype(
        np.float32)
    h0 = np.random.default_rng(5).standard_normal((9, 20)).astype(np.float32)
    y_j, h_j = gru_pallas(p, jnp.asarray(x), jnp.asarray(h0), interpret=True)
    tp_ = from_jax(to_np_tree(p), device="cpu")
    y_t, h_t = gru_fused(tp_, torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5)
    # and it is nn.gru's recurrence (no h0: zeros)
    y_g, h_g = fnn.gru(tp_, torch.from_numpy(x))
    y_f, h_f = gru_fused(tp_, torch.from_numpy(x))
    np.testing.assert_allclose(y_f.numpy(), y_g.numpy(), atol=1e-5)
    np.testing.assert_allclose(h_f.numpy(), h_g.numpy(), atol=1e-5)


def test_plain_version_is_differentiable_on_cpu():
    arrs = [torch.from_numpy(a).requires_grad_() for a in _case(4, 3, 6, 1)]
    ys, h_t = gru_scan(*arrs)
    (ys.square().sum() + h_t.sum()).backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in arrs)


def test_wrapper_checks_shapes_and_device():
    x, h0, w, b = map(torch.from_numpy, _case(3, 4, 5, 0))
    with pytest.raises(ValueError, match="h0"):
        gru_scan(x, h0[:, :4], w, b)
    with pytest.raises(ValueError, match=r"\[T, N, 3H\]"):
        gru_scan(x[..., :-1], h0, w, b)
    with pytest.raises(ValueError, match="device"):
        gru_scan(x.to("meta"), h0.to("meta"), w.to("meta"), b.to("meta"))


# -- the tensor-core form's arithmetic (csrc/gru_scan_tc.cuh), in plain torch


def _tc_columns(h):
    """The tensor-core form's order of W_hh^T's columns: n-tile 3u + q
    holds gate q (r, z, n) of units 8u .. 8u + 7; -1 marks a padded
    column (a unit past H)."""
    cols = []
    for u in range(-(-h // 8)):
        for q in range(3):
            cols += [q * h + 8 * u + j if 8 * u + j < h else -1
                     for j in range(8)]
    return torch.tensor(cols)


def _tc_weights(w_hh, b_hh):
    """W_hh^T permuted and zero-padded to [16 KS, 24 U] (float64, exact for
    bf16 weights) and b_hh permuted (float32)."""
    h = w_hh.shape[1]
    cols = _tc_columns(h)
    pad = cols < 0
    w = torch.zeros(16 * -(-h // 16), len(cols), dtype=torch.float64)
    w[:h] = w_hh.double().T[:, cols.clamp_min(0)]
    w[:, pad] = 0.0
    b = b_hh.float()[cols.clamp_min(0)]
    b[pad] = 0.0
    return w, b, cols, pad


def _tc_scan(x_proj, h0, w_hh, b_hh, split=True):
    """The form's steps: the float32 state as A = hi + lo (two bf16
    halves; split=False rounds it to bf16 once, nn.gru's cast point), the
    products exact (float64) and summed onto b_hh in float32, the gate
    sums read back through the permutation, the cell in float32, ys and
    h_T rounded once to x_proj's type."""
    t, n, h3 = x_proj.shape
    h = h3 // 3
    w, b, cols, pad = _tc_weights(w_hh, b_hh)
    state = torch.zeros(n, w.shape[0])
    state[:, :h] = h0.float()
    ys = []
    for xg in x_proj.float().unbind(0):
        hi = state.bfloat16().float()
        lo = (state - hi).bfloat16().float() if split else torch.zeros_like(hi)
        acc = b + (hi.double() @ w + lo.double() @ w).float()
        gates = torch.zeros(n, h3)
        gates[:, cols[~pad]] = acc[:, ~pad]
        xr, xz, xn = xg.chunk(3, dim=-1)
        hr, hz, hn = gates.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        nc = torch.tanh(xn + r * hn)
        state[:, :h] = nc + z * (state[:, :h] - nc)
        ys.append(state[:, :h].clone())
    dt = x_proj.dtype
    if not ys:
        return x_proj.new_zeros(0, n, h), state[:, :h].to(dt)
    return torch.stack(ys).to(dt), state[:, :h].to(dt)


def test_tc_column_order_round_trips():
    """h . W_perm, read back through the permutation, is h . W_hh^T, and
    every gate column appears once (padding aside)."""
    for h in (18, 20, 36, 5):
        _, _, w_hh, b_hh = _case(1, 1, h, h)
        w, b, cols, pad = _tc_weights(torch.from_numpy(w_hh),
                                      torch.from_numpy(b_hh))
        assert sorted(cols[~pad].tolist()) == list(range(3 * h))
        assert len(cols) == 24 * -(-h // 8) and w.shape[0] % 16 == 0
        x = torch.randn(7, w.shape[0], dtype=torch.float64)
        x[:, h:] = 0.0
        got = torch.zeros(7, 3 * h, dtype=torch.float64)
        got[:, cols[~pad]] = (x @ w)[:, ~pad]
        want = x[:, :h] @ torch.from_numpy(w_hh).double().T
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
        bb = torch.zeros(3 * h)
        bb[cols[~pad]] = b[~pad]
        assert torch.equal(bb, torch.from_numpy(b_hh))


@pytest.mark.parametrize("t,n,h", [(13, 37, 20), (126, 10, 36), (5, 3, 18),
                                   (13, 19, 20)])
def test_tc_arithmetic_matches_pallas_bf16(t, n, h):
    """The form's arithmetic in bf16 against the Pallas kernel (state in
    float32, products in float32): within one bf16 ulp of the peak, and at
    most 1% of the outputs a rounding apart."""
    arrs = [a.astype(jnp.bfloat16) for a in map(jnp.asarray,
                                                  _case(t, n, h, 7 + t))]
    ys_j, ht_j = gru_scan_pallas(*arrs, interpret=True)
    targs = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
             for a in arrs]
    ys_t, ht_t = _tc_scan(*targs)
    ys_j = np.asarray(ys_j, np.float32)
    tol = 2 ** -7 * np.abs(ys_j).max()
    assert np.abs(ys_t.float().numpy() - ys_j).max() <= tol
    assert np.abs(ht_t.float().numpy() - np.asarray(ht_j, np.float32)
                  ).max() <= tol
    assert (ys_t.float().numpy() != ys_j).mean() <= 0.01


@pytest.mark.parametrize("t,n,h,h0", [(126, 10, 36, True),
                                      (13, 37, 20, False), (5, 3, 18, True)])
def test_tc_arithmetic_keeps_the_float32_state(t, n, h, h0):
    """In float32 the form's arithmetic stays within 1e-5 of the plain
    version over 126 steps: the hi/lo split keeps the state float32. The
    control, h rounded to bf16 once a step, misses that bound."""
    arrs = [torch.from_numpy(a) for a in _case(t, n, h, 3 + n, h0)]
    ys_r, ht_r = gru_scan_reference(*arrs)
    ys_t, ht_t = _tc_scan(*arrs)
    torch.testing.assert_close(ys_t, ys_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(ht_t, ht_r, rtol=0, atol=1e-5)
    ys_c, _ = _tc_scan(*arrs, split=False)
    assert (ys_c - ys_r).abs().max() > 1e-5


def test_kernel_form_and_geometry():
    """tc for bfloat16 at every preset's time-GRU width and every even H up
    to 128, scalar for float32 and odd H; tiles of 16 rows; the shared
    memory fits."""
    widths = {kw["rnnformer_kwargs"]["channels"]
              for kw in (presets.FE_B, presets.LN_B, presets.TIME_KERNEL_B,
                         presets.FE_T_SHARD["model_kwargs"])}
    assert widths == {20, 36}
    for h in sorted(widths) + [18, 64, 128, 2]:
        assert scan.kernel_form(1024, h, torch.bfloat16) == "tc"
        assert scan.kernel_form(1024, h, torch.float32) == "scalar"
    for h in (21, 1, 130):
        assert scan.kernel_form(1024, h, torch.bfloat16) == "scalar"
    assert scan.kernel_form(0, 20, torch.bfloat16) == "scalar"
    assert scan.kernel_form(5, 20, torch.float16) == "scalar"
    assert scan.tc_tiles(1024) == 64 and scan.tc_tiles(301) == 19
    assert scan.tc_tiles(16) == 1 and scan.tc_tiles(17) == 2
    # one unit group of 8 a warp up to H = 64, two above, at most 8 warps
    assert {h: scan.tc_warps(h) for h in (8, 16, 20, 36, 64, 66, 128)} == {
        8: 1, 16: 2, 20: 3, 36: 5, 64: 8, 66: 5, 128: 8}
    # the double-buffered hi/lo h tile; at H = 128 W_hh's fragments in
    # shared memory too, within the 227 KB of a block
    assert scan.tc_smem_bytes(20) == 4 * 16 * _build.ld_of(32) * 2
    big = scan.tc_smem_bytes(128)
    assert big == 4 * 16 * _build.ld_of(128) * 2 + 48 * 8 * 32 * 8
    assert big <= _build.MAX_SMEM_BYTES


def test_direct_launches_refuse_cpu_tensors_and_other_forms():
    """launch_tc and launch_scalar run on the card only; launch_tc takes
    only what kernel_form gives to it."""
    args = [torch.from_numpy(a) for a in _case(3, 4, 20, 0)]
    with pytest.raises(ValueError, match="tensor-core form"):
        scan.launch_tc(*args)  # float32
    with pytest.raises(ValueError, match="tensor-core form"):
        scan.launch_tc(*[torch.from_numpy(a).bfloat16()
                         for a in _case(3, 4, 21, 0)])  # odd H
    with pytest.raises(ValueError, match="CUDA"):
        scan.launch_tc(*[a.bfloat16() for a in args])
    with pytest.raises(ValueError, match="CUDA"):
        scan.launch_scalar(*args)
