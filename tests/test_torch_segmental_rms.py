"""ops/segmental_rms.py (kernel 4's plain version and its CPU wrapper)
against the JAX package's XLA form and its Pallas kernel, the latter in
TPU interpret mode as tests/test_shard_pipeline.py runs it.

Tolerances: float32 rtol 1e-6 (one frame-power reduction and one masked
mean); bfloat16 one bf16 ulp (2^-7 relative; the port sums in float32,
JAX in the input's type). The kernel's cluster size and its partition of
a row's frames over the cluster are checked here too.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from fastenhancer_tpu.ops.segmental_rms import (segmental_rms as jrms,
                                                segmental_rms_pallas)
from fastenhancer_tpu_torch.ops import segmental_rms as seg
from fastenhancer_tpu_torch.ops.segmental_rms import (segmental_rms,
                                                      segmental_rms_fused)

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SR = 16_000
WIN = SR // 10


def _rows(t, seed=0):
    """4 rows: noise at -20 dB, a silent row, a row 60 dB quieter in its
    first half (the relative threshold drops those frames), and a row at
    -60 dB throughout (below the -50 dB absolute floor)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, t)) * 0.1).astype(np.float32)
    x[1] = 0.0
    x[2, : t // 2] *= 1e-3
    x[3] *= 1e-2
    return x


CASES = [(64_000, -50.0), (64_000, None), (5 * WIN + 700, -50.0),
         (5 * WIN + 700, None), (WIN - 300, -50.0)]
IDS = ["T=40win-abs", "T=40win-noabs", "T=5win+700-abs", "T=5win+700-noabs",
       "T<win"]


@pytest.mark.parametrize("t,abs_db", CASES, ids=IDS)
def test_matches_jax_xla_and_pallas(t, abs_db):
    wav = _rows(t)
    want = np.asarray(jrms(jnp.asarray(wav), absolute_threshold_db=abs_db))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(segmental_rms_pallas(
            jnp.asarray(wav), SR, 100, -25.0, abs_db))
    for fn in (segmental_rms, segmental_rms_fused):
        got = fn(torch.from_numpy(wav), absolute_threshold_db=abs_db)
        assert got.shape == (4, 1, 1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6)
    if t >= WIN:
        assert np.isinf(want[1]).all()  # the silent row: nothing active


def test_thresholds_bite():
    """The quiet half of row 2 is left out (its RMS is the loud half's);
    the -50 dB floor leaves nothing active in row 3 (+inf), and without it
    row 3's RMS is that of the whole row."""
    wav = torch.from_numpy(_rows(64_000))
    rms = segmental_rms(wav).flatten()
    loud = wav[2, 32_000:].square().mean().sqrt()
    assert torch.isclose(rms[2], loud, rtol=1e-3)
    assert torch.isinf(rms[3])
    no_floor = segmental_rms(wav, absolute_threshold_db=None).flatten()
    assert torch.isclose(no_floor[3], wav[3].square().mean().sqrt(),
                         rtol=1e-3)


def test_bfloat16_and_three_dim_input():
    wav = _rows(5 * WIN + 700, seed=1)
    want = np.asarray(jrms(jnp.asarray(wav)))
    x = torch.from_numpy(wav).bfloat16()[:, None, :]
    got = segmental_rms_fused(x)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 1, 1)
    ref = np.asarray(jrms(jnp.asarray(x.float().numpy()[:, 0])))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6)


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="device"):
        segmental_rms_fused(torch.zeros(2, 3200, device="meta"))


def test_cluster_size_by_batch():
    """The largest of 8, 4, 2, 1 blocks a row within one wave of 132 SMs."""
    assert {b: seg.cluster_size(b) for b in (1, 5, 16, 17, 32, 33, 34, 66,
                                             67, 200)} == {
        1: 8, 5: 8, 16: 8, 17: 4, 32: 4, 33: 4, 34: 2, 66: 2, 67: 1,
        200: 1}


@pytest.mark.parametrize("t", [64_000, 64_003, 5 * WIN + 700, WIN - 300,
                               7 * WIN])
def test_frames_dealt_once_over_the_cluster(t):
    """Every frame of a row goes to exactly one block of its cluster, in
    contiguous runs; a row shorter than a frame deals none (rank 0 sums
    the whole row). Summing the powers block by block, as the cluster
    gathers them, gives the plain version's result."""
    n = t // WIN
    wav = torch.from_numpy(_rows(t, seed=2))
    want = segmental_rms(wav, absolute_threshold_db=-50.0).flatten()
    frames = wav[:, : n * WIN].reshape(4, n, WIN).square().mean(-1)
    for k in (1, 2, 4, 8):
        dealt = [f for r in range(k) for f in seg.frame_range(n, k, r)]
        assert dealt == list(range(n))
        gathered = torch.cat([frames[:, seg.frame_range(n, k, r)]
                              for r in range(k)], dim=1)
        assert torch.equal(gathered, frames)
    if n == 0:
        return
    thr = (frames.amax(-1, keepdim=True) * 10 ** -2.5).clamp_min(1e-5)
    act = frames > thr
    rms = torch.where(act.any(-1), ((frames * act).sum(-1)
                                    / act.sum(-1).clamp_min(1)).sqrt(),
                      torch.full((4,), float("inf")))
    torch.testing.assert_close(rms, want, rtol=1e-6, atol=0)
