"""ops/gru_scan.py (kernel 5's plain version and its CPU wrapper) against
the JAX package's Pallas kernel `gru_scan_pallas` and its drop-in
`gru_pallas`, both in interpret mode as tests/test_ops_pallas.py runs them.

Tolerances: float32 1e-5 (T steps of recurrence at unit scale); bfloat16
one bf16 ulp of the largest magnitude (2^-7): both round only ys and h_T,
so the float32 states differ only by the order of their sums.
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
from fastenhancer_tpu_torch.ops.gru_scan import (gru_fused, gru_scan,
                                                 gru_scan_reference)
from fastenhancer_tpu_torch.utils import from_jax

from _torch_parity import to_np_tree


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
