"""The port's metrics (copies: numpy and scipy only) against the JAX
package's: STOI, ESTOI, the native P.862 PESQ and SISDR to 1e-9 on
synthetic speech-like signals, and the `Metrics` executor's results and
state against JAX's."""
import numpy as np
import pytest

from fastenhancer_tpu import metrics as jmetrics
from fastenhancer_tpu.metrics import pesq_native as jpesq
from fastenhancer_tpu_torch import metrics
from fastenhancer_tpu_torch.metrics import pesq_native

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SR = 16_000
TOL = 1e-9


def _pair(seed, seconds=2.0, snr_db=5.0, sr=SR):
    """Speech-like clean (noise under a 3 Hz envelope, a silent stretch)
    and a noisy copy at `snr_db`."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6))
    clean = rng.standard_normal(n) * 0.1 * env
    clean[n // 3: n // 2] = 0.0
    noise = rng.standard_normal(n)
    noise *= np.sqrt((clean ** 2).mean() / (noise ** 2).mean()
                     / 10 ** (snr_db / 10))
    return clean.astype(np.float32), (clean + noise).astype(np.float32)


@pytest.mark.parametrize("seed,snr", [(0, 5.0), (1, 20.0), (2, -5.0)])
def test_stoi_estoi_pesq_sisdr_match_jax(seed, snr):
    clean, noisy = _pair(seed, snr_db=snr)
    for port_fn, jax_fn in ((metrics.stoi, jmetrics.stoi),
                            (metrics.estoi, jmetrics.estoi)):
        got, want = port_fn(clean, noisy, SR), jax_fn(clean, noisy, SR)
        assert 0.0 < want <= 1.0
        assert abs(got - want) <= TOL
    got = pesq_native.pesq(SR, clean, noisy, "wb")
    want = jpesq.pesq(SR, clean, noisy, "wb")
    assert 1.0 <= want <= 4.65 and abs(got - want) <= TOL
    got = pesq_native.pesq(8000, clean[::2], noisy[::2], "nb")
    want = jpesq.pesq(8000, clean[::2], noisy[::2], "nb")
    assert abs(got - want) <= TOL
    assert abs(metrics.sisdr(noisy, clean) - jmetrics.sisdr(noisy, clean)) \
        <= TOL
    # another sampling rate goes through the resampler
    assert abs(metrics.pesq_wb(clean, noisy, 24000)
               - jmetrics.pesq_wb(clean, noisy, 24000)) <= TOL


def test_identity_scores():
    clean, _ = _pair(3)
    assert abs(metrics.stoi(clean, clean, SR) - 1.0) < 1e-6
    assert abs(pesq_native.pesq(SR, clean, clean, "wb") - 4.644) < 1e-3
    assert metrics.pesq_provider() == jmetrics.pesq_provider()


def test_metrics_executor_matches_jax():
    """submit/retrieve over two epochs with wav_len cuts, the best-epoch
    bookkeeping, state_dict/load_state_dict and print()."""
    port = metrics.Metrics(num_workers=2, sr=SR)
    jax_m = jmetrics.Metrics(num_workers=2, sr=SR)
    for epoch, snr in ((1, 0.0), (2, 15.0), (3, -5.0)):
        for m in (port, jax_m):
            m.initialize()
        for seed in range(2):
            pairs = [_pair(10 * epoch + seed + k, seconds=1.5, snr_db=snr)
                     for k in range(2)]
            clean = np.stack([c for c, _ in pairs])
            noisy = np.stack([n for _, n in pairs])
            wav_len = np.array([clean.shape[1], clean.shape[1] - 3000])
            for m in (port, jax_m):
                m.submit(clean, noisy, wav_len)
        got, want = port.retrieve(epoch), jax_m.retrieve(epoch)
        assert got.keys() == want.keys() == {"metrics/pesq", "metrics/stoi"}
        for k in want:
            assert abs(got[k] - want[k]) <= TOL, k
    assert port.state_dict().keys() == jax_m.state_dict().keys()
    for k, v in jax_m.state_dict().items():
        assert abs(port.state_dict()[k] - v) <= TOL, k
    assert port.best["pesq_epoch"] == 2 and port.best["stoi_epoch"] == 2
    assert port.print() == jax_m.print()
    fresh = metrics.Metrics(sr=SR)
    fresh.load_state_dict(jax_m.state_dict())
    assert fresh.print() == jax_m.print()
    fresh.load_state_dict(None)
    assert fresh.retrieve(4) == {}


def test_metrics_skips_unscorable_items():
    m, jm = metrics.Metrics(sr=SR), jmetrics.Metrics(sr=SR)
    silent = np.zeros((1, SR), np.float32)
    for x in (m, jm):
        x.submit(silent, silent)
    got, want = m.retrieve(1), jm.retrieve(1)
    assert got.keys() == want.keys()
