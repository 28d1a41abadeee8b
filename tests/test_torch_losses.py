"""losses.py against fastenhancer_tpu/losses.py: each item loss, the
consistency loss, and `Losses.calculate` with and without a row mask, with
the gradients on masked rows. Tolerance: float32 rtol 1e-5."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu import losses as jl
from fastenhancer_tpu_torch import losses as tl

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

B, F, T, L = 3, 17, 9, 640
CFG = {"mag_mse": {"weight": 0.3}, "complex_mse": {"weight": 0.2},
       "consistency": {"weight": 0.3, "compression": 0.3, "n_fft": 128,
                       "hop_size": 64, "win_size": 128, "win_type": "hann"},
       "wav_l1": {"weight": 0.2}, "phase": {"weight": 0.1},
       "si_snr": {"weight": 0.05}}


def _inputs(seed, zero_row=None):
    rng = np.random.default_rng(seed)
    wh = rng.standard_normal((B, L)).astype(np.float32) * 0.1
    w = rng.standard_normal((B, L)).astype(np.float32) * 0.1
    sh = rng.standard_normal((B, F, T, 2)).astype(np.float32)
    s = rng.standard_normal((B, F, T, 2)).astype(np.float32)
    if zero_row is not None:
        for a in (wh, w, sh, s):
            a[zero_row] = 0.0
    return wh, sh, w, s


@pytest.mark.parametrize("name", ["si_snr", "wav_l1", "mag_mse",
                                  "complex_mse", "phase"])
def test_item_losses_match_jax(name):
    wh, sh, w, s = _inputs(0)
    wav = name in ("si_snr", "wav_l1")
    a, b = (wh, w) if wav else (sh, s)
    want = getattr(jl, f"{name}_items")(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tl, f"{name}_items")(torch.from_numpy(a),
                                       torch.from_numpy(b))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_consistency_matches_jax():
    wh, _, w, _ = _inputs(1)
    kw = {k: v for k, v in CFG["consistency"].items() if k != "weight"}
    want = jl.ConsistencyLoss(**kw).items(jnp.asarray(wh), jnp.asarray(w))
    got = tl.ConsistencyLoss(**kw).items(torch.from_numpy(wh),
                                         torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_calculate_matches_jax_and_masked_rows_have_finite_grads(masked):
    """With row_mask [1, 1, 0] on a batch whose row 2 is all zeros (a
    padded row): the masked means agree with JAX, and the gradients are
    finite everywhere and zero on the padded row."""
    wh, sh, w, s = _inputs(2, zero_row=2 if masked else None)
    mask = np.array([1, 1, 0], np.float32) if masked else None
    jlos, tlos = jl.Losses(CFG), tl.Losses(CFG)

    def jtotal(wh_, sh_):
        return jlos.calculate(wh_, sh_, jnp.asarray(w), jnp.asarray(s),
                              None if mask is None else jnp.asarray(mask))
    (jt, jper), (jg_w, jg_s) = jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True)(jnp.asarray(wh),
                                              jnp.asarray(sh))
    twh = torch.from_numpy(wh).requires_grad_()
    tsh = torch.from_numpy(sh).requires_grad_()
    tt, tper = tlos.calculate(twh, tsh, torch.from_numpy(w),
                              torch.from_numpy(s),
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-5)
    assert tper.keys() == jper.keys()
    for k in jper:
        np.testing.assert_allclose(tper[k].item(), float(jper[k]), rtol=1e-5)
    tt.backward()
    for g, jg in ((twh.grad, jg_w), (tsh.grad, jg_s)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-7)
        if masked:
            assert not g[2].any()


def test_epoch_bookkeeping():
    los = tl.Losses({"wav_l1": {"weight": 1.0}, "mag_mse": {"weight": 2.0}})
    los.accumulate({"wav_l1": torch.tensor(1.0), "mag_mse": 4.0}, 2)
    los.accumulate({"wav_l1": torch.tensor(4.0), "mag_mse": 1.0}, 1)
    assert los.reduce() == {"loss/wav_l1": 2.0, "loss/mag_mse": 3.0}
    los.initialize()
    assert los.get("wav_l1") == 0.0
    # the pesq loss, once refused, is a wav loss of its own (parity with
    # JAX: tests/test_torch_pesq_loss.py)
    los = tl.Losses({"pesq": {"weight": 1.0}})
    assert los.fns["pesq"][0] == "wav" and los.reduce() == {"loss/pesq": 0.0}
