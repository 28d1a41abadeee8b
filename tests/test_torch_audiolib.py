"""The port's audio tools (fastenhancer_tpu_torch/scripts/audiolib.py)
against scripts/audiolib.py: each function on the same seeded float64 and
float32 inputs gives exactly the same result."""
import numpy as np
import pytest

from fastenhancer_tpu_torch.scripts import audiolib as port
from scripts import audiolib as jax_lib

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SR = 16000


def _speech(rng, dtype, seconds=3.0):
    """Tone bursts with silent stretches and a quiet floor."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = (np.sin(2 * np.pi * 0.7 * t) > 0.2).astype(np.float64)
    x = 0.3 * env * np.sin(2 * np.pi * 220 * t) * rng.uniform(0.5, 1.0)
    x += 1e-4 * rng.standard_normal(n)
    return x.astype(dtype)


def _rir(rng, dtype, onset=37):
    t = np.arange(SR // 2)
    r = rng.standard_normal(len(t)) * np.exp(-6.9 * t / (0.3 * SR))
    r[:onset] = 0.0
    r[onset] = 3.0 * np.abs(r).max()
    return (r / np.abs(r).max()).astype(dtype)


def _inputs(name, dtype):
    """(args, kwargs) cases of one function, from one seeded generator:
    ordinary signals and the edge cases its code branches on."""
    rng = np.random.default_rng(sum(map(ord, name)))
    speech, rir = _speech(rng, dtype), _rir(rng, dtype)
    silent = np.zeros(SR, dtype)
    floor = (1e-5 * rng.standard_normal(2 * SR)).astype(dtype)
    if name == "active_rms_relative":
        return [((speech,), {}), ((speech, SR), {"window_ms": 32,
                                                 "relative_threshold_db": -35.0,
                                                 "absolute_threshold_db": None}),
                ((silent,), {}), ((speech[:100],), {}), ((floor,), {})]
    if name == "normalize_segmental_rms":
        return [((speech, float(jax_lib.active_rms_relative(speech))), {}),
                ((speech, 0.0), {"target_level_db": -30.0})]
    if name in ("get_rir_start_sample", "find_rir_onset_spectral"):
        return [((rir,), {}), ((silent[:500],), {}), ((rir[:100],), {}),
                ((np.roll(rir, 300),), {})]
    if name == "estimate_t60":
        return [((rir,), {}), ((rir, 8000), {}), ((silent[:64],), {})]
    assert name == "vad_segments"
    long = np.concatenate([speech, np.zeros(SR // 2, dtype), speech])
    return [((long,), {}), ((long, SR), {"frame_ms": 20.0,
                                         "threshold_db": -25.0,
                                         "max_gap_sec": 0.1}),
            ((floor,), {}), ((speech[:100],), {})]


FUNCTIONS = ["active_rms_relative", "normalize_segmental_rms",
             "get_rir_start_sample", "find_rir_onset_spectral",
             "estimate_t60", "vad_segments"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_audiolib_equals_jax(name, dtype):
    for args, kw in _inputs(name, dtype):
        got = getattr(port, name)(*args, **kw)
        want = getattr(jax_lib, name)(*args, **kw)
        assert type(got) is type(want)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        else:
            assert got == want, (name, got, want)


def test_audiolib_cases_reach_both_branches():
    """The inputs above take each function down its branches: an active
    and a silent RMS, a found and a defaulted onset and T60, segments and
    none."""
    speech = _speech(np.random.default_rng(0), np.float32)
    rir = _rir(np.random.default_rng(0), np.float32)
    assert port.active_rms_relative(speech) > 0.0
    assert port.active_rms_relative(np.zeros(SR, np.float32)) == 0.0
    assert port.get_rir_start_sample(rir) == 37
    assert port.get_rir_start_sample(np.zeros(500, np.float32)) == 0
    assert 0.1 < port.estimate_t60(rir) < 1.0
    assert port.estimate_t60(np.zeros(64, np.float32)) == 0.5
    long = np.concatenate([speech, np.zeros(SR // 2, np.float32), speech])
    assert len(port.vad_segments(long)) >= 2
    assert port.vad_segments(np.zeros(SR, np.float32)) == []
