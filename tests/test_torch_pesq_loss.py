"""pesq_loss.py against fastenhancer_tpu/pesq_loss.py: the per-item loss on
seeded 16 kHz pairs (among them an identity pair, a silent degraded row
and a silent reference row), its gradient with respect to the degraded
signal, and the `pesq` term of a recipe's `Losses`. Tolerances (float32):
values rtol 1e-5, gradients rtol 1e-4 (atol 1e-4 of the largest
magnitude)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu import losses as jl
from fastenhancer_tpu.pesq_loss import PESQLoss as JPESQLoss
from fastenhancer_tpu_torch import losses as tl
from fastenhancer_tpu_torch.pesq_loss import PESQLoss

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

# configs/fastenhancer/b.yaml's losses at a 128-point STFT
RECIPE = {"mag_mse": {"weight": 0.3}, "complex_mse": {"weight": 0.2},
          "consistency": {"weight": 0.3, "compression": 0.3, "n_fft": 128,
                          "hop_size": 64, "win_size": 128,
                          "win_type": "hann"},
          "wav_l1": {"weight": 0.2}, "pesq": {"weight": 0.001}}


def _pairs(seed, rows=5, t=8000):
    """(ref, deg) [rows, t]: noisy copies, an identity pair (row 1), a
    silent degraded row (2), a silent reference row (3)."""
    rng = np.random.default_rng(seed)
    ref = (rng.standard_normal((rows, t)) * 0.1).astype(np.float32)
    deg = (ref + rng.standard_normal(ref.shape)
           * rng.uniform(0.01, 0.2, (rows, 1))).astype(np.float32)
    deg[1] = ref[1]
    deg[2] = 0.0
    ref[3] = 0.0
    return ref, deg


@pytest.mark.parametrize("seed", [0, 1])
def test_items_match_jax(seed):
    ref, deg = _pairs(seed)
    want = np.asarray(jax.jit(JPESQLoss().items)(jnp.asarray(ref),
                                                 jnp.asarray(deg)))
    got = PESQLoss().items(torch.from_numpy(ref), torch.from_numpy(deg))
    assert got.shape == (len(ref),) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert got[1] == 0.0 and (got[[0, 2, 3, 4]] > 0).all()
    mean = PESQLoss()(torch.from_numpy(ref), torch.from_numpy(deg))
    np.testing.assert_allclose(float(mean), want.mean(), rtol=1e-5)


def test_gradient_matches_jax():
    """d items.sum() / d deg against jax.grad, finite on every row (the
    power is re^2 + im^2, so a silent row has no 0/0)."""
    ref, deg = _pairs(2)
    jfn = JPESQLoss()
    want = np.asarray(jax.jit(jax.grad(
        lambda d: jfn.items(jnp.asarray(ref), d).sum()))(jnp.asarray(deg)))
    d = torch.from_numpy(deg).requires_grad_()
    PESQLoss().items(torch.from_numpy(ref), d).sum().backward()
    g = d.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_tables_follow_the_input_and_16k_only():
    loss = PESQLoss()
    x = torch.zeros(1, 1024, dtype=torch.float64)
    assert loss.items(x, x).dtype == torch.float32
    assert set(loss.tables(torch.device("cpu"))) == {"bark_t", "window",
                                                      "thr"}
    assert loss.tables(torch.device("cpu"))["bark_t"].shape == (257, 49)
    with pytest.raises(ValueError, match="16 kHz"):
        PESQLoss(sample_rate=48_000)


def test_recipe_losses_with_pesq_match_jax():
    """The recipe's weighted sum with `pesq` at 0.001 and a padded row:
    every term, the total, and the gradients of both wavs."""
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((3, 64 * 16)) * 0.1).astype(np.float32)
    wav_hat = (wav + rng.standard_normal(wav.shape) * 0.05).astype(
        np.float32)
    wav[2] = wav_hat[2] = 0.0
    mask = np.array([1, 1, 0], np.float32)
    spec = rng.standard_normal((3, 33, 17, 2)).astype(np.float32)
    spec_hat = rng.standard_normal((3, 33, 17, 2)).astype(np.float32)
    jlos, tlos = jl.Losses(RECIPE), tl.Losses(RECIPE)
    assert tlos.fns["pesq"][0] == "wav"

    def jtotal(wh):
        return jlos.calculate(wh, jnp.asarray(spec_hat), jnp.asarray(wav),
                              jnp.asarray(spec), jnp.asarray(mask))
    (jt, jper), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(wav_hat))
    twh = torch.from_numpy(wav_hat).requires_grad_()
    tt, tper = tlos.calculate(twh, torch.from_numpy(spec_hat),
                              torch.from_numpy(wav), torch.from_numpy(spec),
                              torch.from_numpy(mask))
    assert tper.keys() == jper.keys() and "pesq" in tper
    for k in jper:
        np.testing.assert_allclose(float(tper[k].detach()), float(jper[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tt.detach()), float(jt), rtol=1e-5)
    tt.backward()
    g = twh.grad.numpy()
    assert np.isfinite(g).all() and not g[2].any()
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jg)).max())
