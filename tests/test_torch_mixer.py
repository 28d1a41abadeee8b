"""data/shard_mixer.py against fastenhancer_tpu/data/shard_mixer.py.

The JAX mixer draws dBFS, SNR and SER from `jax.random.split(key, 4)`; the
test makes the same draws and hands them to the port's `DynamicMixer.mix`,
so both mix the same numpy batch with the same numbers. Tolerance: 1e-5
of the largest magnitude (float32 FFT convolutions of 0.5 s RIRs, by two
FFT libraries).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.data import shard_mixer as jmix
from fastenhancer_tpu_torch.data import shard_mixer as tmix

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SR = 16_000
B, T, T_RIR = 6, 8_000, 8_000
T60_MAX = 0.15


def _batch(seed, loud=False):
    """Speech with a silent stretch, noise with a silent row, RIRs: unit
    impulses on half the rows, decaying noise with t60 above and below
    t60_max on the others; an echo with a silent row, half of it real."""
    rng = np.random.default_rng(seed)
    speech = (rng.standard_normal((B, 1, T)) * 0.1).astype(np.float32)
    speech[:, :, : T // 4] *= 1e-3
    noise = (rng.standard_normal((B, 1, T)) * (0.9 if loud else 0.05)
             ).astype(np.float32)
    noise[2] = 0.0
    rir = np.zeros((B, 1, T_RIR), np.float32)
    rir[:, 0, 0] = 1.0
    onset = np.zeros(B, np.int64)
    t60 = np.full(B, 1e-3, np.float32)
    n = np.arange(T_RIR)
    for i, (o, t) in enumerate(((40, 0.4), (0, 0.1), (200, 0.3)), start=3):
        r = rng.standard_normal(T_RIR) * np.exp(-6.9 * n / (t * SR))
        r[:o] = 0.0
        rir[i, 0] = (r / np.abs(r).max()).astype(np.float32)
        onset[i], t60[i] = o, t
    echo = (rng.standard_normal((B, 1, T)) * 0.05).astype(np.float32)
    echo[0] = 0.0
    is_real = np.array([0, 1, 0, 1, 0, 1], bool)
    return dict(speech=speech, speech_clean=speech.copy(), noise=noise,
                rir=rir, rir_onset=onset, rir_t60=t60, echo=echo,
                is_real=is_real)


def _jax_draws(key, mixer):
    k_dbfs, k_snr, k_ser_r, k_ser_s = jax.random.split(key, 4)
    u = lambda k, lo_hi: jax.random.uniform(  # noqa: E731
        k, (B,), minval=lo_hi[0], maxval=lo_hi[1])
    return [np.array(u(k, r)) for k, r in ((k_dbfs, mixer.dbFS),
                                           (k_snr, mixer.snr),
                                           (k_ser_r, mixer.ser_real),
                                           (k_ser_s, mixer.ser))]


def _close(got, want):
    want = np.asarray(want)
    tol = 1e-5 * max(np.abs(want).max(), 1e-30)
    assert np.abs(got.numpy() - want).max() <= tol


@pytest.mark.parametrize("target,echo,loud", [
    ("rts", False, False), ("rts", True, True), ("early_rir", False, False),
    ("weighted_rir", True, False), (None, False, False),
    ("anechoic", False, True)])
def test_mix_matches_jax_under_its_draws(target, echo, loud):
    kw = dict(speech_dbFS=(-35.0, -15.0) if not loud else (-3.0, 0.0),
              snr=(0.0, 20.0) if not loud else (-5.0, 0.0),
              seg_rel_threshold=-25.0, seg_abs_threshold=None,
              rir_target_type=target, t60_max=T60_MAX)
    jm, tm = jmix.DynamicMixer(**kw), tmix.DynamicMixer(**kw)
    arrs = _batch(1, loud)
    if not echo:
        arrs.pop("echo")
        arrs.pop("is_real")
    key = jax.random.PRNGKey(7)
    want = jm(key, **{k: jnp.asarray(v) for k, v in arrs.items()})
    draws = [torch.from_numpy(d) for d in _jax_draws(key, jm)]
    got = tm.mix(*draws, **{k: torch.from_numpy(v) for k, v in arrs.items()})
    for k in ("speech", "speech_clean"):
        _close(got[k], want[k])
    assert torch.isfinite(got["speech"]).all()
    if loud:  # the joint peak clip acted
        peak = max(got["speech"].abs().max(), got["speech_clean"].abs().max())
        assert peak <= 1.0
    for k in ("dbFS", "snr", "ser"):
        if want[k] is None:
            assert got[k] is None
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]))


def test_rir_helpers_match_jax():
    a = _batch(2)
    rir, onset, t60 = (torch.from_numpy(a[k]) for k in
                       ("rir", "rir_onset", "rir_t60"))
    j = {k: jnp.asarray(a[k]) for k in ("rir", "rir_onset", "rir_t60")}
    _close(tmix.get_rts_rir(rir, onset, t60, T60_MAX),
           jmix.get_rts_rir(j["rir"], j["rir_onset"], j["rir_t60"], T60_MAX))
    _close(tmix.get_early_rir(rir, onset), jmix.get_early_rir(
        j["rir"], j["rir_onset"]))
    _close(tmix.get_weighted_rir(rir, onset, T60_MAX), jmix.get_weighted_rir(
        j["rir"], j["rir_onset"], T60_MAX))
    speech = torch.from_numpy(a["speech"])
    _close(tmix.batch_convolve_rir(speech, rir),
           jmix.batch_convolve_rir(jnp.asarray(a["speech"]), j["rir"]))
    # rts: rows with t60 <= t60_max pass through, the others decay
    rts = tmix.get_rts_rir(rir, onset, t60, T60_MAX)
    for i in range(B):
        if a["rir_t60"][i] <= T60_MAX:
            assert torch.equal(rts[i], rir[i])
        else:
            assert rts[i].abs().sum() < rir[i].abs().sum()


def test_rts_backward_is_finite():
    """The two clamps keep reverse mode free of NaNs on passthrough rows."""
    a = _batch(3)
    rir = torch.from_numpy(a["rir"]).requires_grad_()
    t60 = torch.tensor([0.0, 1e-3, 0.1, 0.4, 0.15, 0.3])
    tmix.get_rts_rir(rir, torch.from_numpy(a["rir_onset"]), t60,
                     T60_MAX).sum().backward()
    assert torch.isfinite(rir.grad).all()


def test_call_draws_from_the_generator():
    """__call__ draws within the ranges, the same for one seed."""
    m = tmix.DynamicMixer(speech_dbFS=(-35.0, -15.0), snr=(0.0, 20.0))
    arrs = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    out1 = m(torch.Generator().manual_seed(3), **arrs)
    out2 = m(torch.Generator().manual_seed(3), **arrs)
    assert torch.equal(out1["speech"], out2["speech"])
    assert ((out1["dbFS"] >= -35) & (out1["dbFS"] <= -15)).all()
    assert ((out1["snr"] >= 0) & (out1["snr"] <= 20)).all()
