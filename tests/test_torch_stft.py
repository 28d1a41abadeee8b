"""PyTorch port of functional/stft.py against the JAX package.

Same numpy inputs through both. Tolerance: float32 rounding of a 128- or
512-point DFT, 1e-5 absolute on unit-scale signals.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fastenhancer_tpu import functional as jf
from fastenhancer_tpu_torch import functional as tf

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5  # float32 DFT of unit-scale frames


def _cfgs(method, n_fft=128, hop=64):
    return (jf.STFTConfig(n_fft=n_fft, hop_size=hop, method=method),
            tf.STFTConfig(n_fft=n_fft, hop_size=hop, method=method))


def test_constants_equal_jax():
    """Windows and DFT matrices are the same numpy math in both packages."""
    for win in ("hann", "povey", "hann-sqrt", "hamming", "blackman", None):
        jc = jf.STFTConfig(n_fft=128, hop_size=32, win_size=96, win_type=win,
                           normalized=True)
        pc = tf.STFTConfig(n_fft=128, hop_size=32, win_size=96, win_type=win,
                           normalized=True)
        for name in ("window", "synthesis_window", "dft_matrix",
                     "idft_matrix"):
            np.testing.assert_array_equal(getattr(pc, name),
                                          getattr(jc, name), err_msg=name)


@pytest.mark.parametrize("method", ["fft", "matmul"])
def test_offline_stft_istft_match_jax(method):
    jc, pc = _cfgs(method)
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((2, 64 * 12)).astype(np.float32) * 0.3
    spec_j = np.asarray(jf.stft(jnp.asarray(wav), jc))
    spec_p = tf.stft(torch.from_numpy(wav), pc)
    np.testing.assert_allclose(spec_p.numpy(), spec_j, atol=ATOL)
    y_j = np.asarray(jf.istft(jnp.asarray(spec_j), jc, length=wav.shape[1]))
    y_p = tf.istft(torch.tensor(spec_j), pc, length=wav.shape[1])
    np.testing.assert_allclose(y_p.numpy(), y_j, atol=ATOL)
    np.testing.assert_allclose(y_p.numpy(), wav, atol=1e-4)  # round trip


def test_overlap_add_general_hop_matches_jax():
    """hop not dividing n_fft takes the scatter path."""
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((2, 7, 20)).astype(np.float32)
    y_j = np.asarray(jf.overlap_add(jnp.asarray(frames), 6))
    y_p = tf.overlap_add(torch.from_numpy(frames), 6)
    np.testing.assert_allclose(y_p.numpy(), y_j, atol=1e-6)


@pytest.mark.parametrize("method", ["fft", "matmul"])
def test_streaming_steps_match_jax(method):
    """Eight analysis and synthesis hops, carries fed back on both sides."""
    jc, pc = _cfgs(method, n_fft=512, hop=256)
    rng = np.random.default_rng(2)
    b = 3
    cj = jf.init_stft_carry(jc, b)
    cp = tf.init_stft_carry(pc, b, torch.float32, "cpu")
    oj = jf.init_istft_carry(jc, b)
    op = tf.init_istft_carry(pc, b, torch.float32, "cpu")
    for _ in range(8):
        hop = rng.standard_normal((b, 256)).astype(np.float32) * 0.3
        spec_j, cj = jf.stft_streaming_step(jnp.asarray(hop), cj, jc)
        spec_p, cp = tf.stft_streaming_step(torch.from_numpy(hop), cp, pc)
        np.testing.assert_allclose(spec_p.numpy(), np.asarray(spec_j),
                                   atol=ATOL)
        np.testing.assert_allclose(cp.numpy(), np.asarray(cj), atol=0)
        y_j, oj = jf.istft_streaming_step(spec_j, oj, jc)
        y_p, op = tf.istft_streaming_step(torch.tensor(
            np.asarray(spec_j)), op, pc)
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=ATOL)
        np.testing.assert_allclose(op.numpy(), np.asarray(oj), atol=ATOL)


def test_streaming_step_bf16_casts_match_jax():
    """bf16 in: the frame is float32, the spec and carries come back bf16,
    as in the JAX step. Tolerance: one bf16 ulp of the largest value."""
    import ml_dtypes

    jc, pc = _cfgs("matmul", n_fft=512, hop=256)
    rng = np.random.default_rng(3)
    hop = rng.standard_normal((2, 256)).astype(ml_dtypes.bfloat16)
    carry = rng.standard_normal((2, 256)).astype(ml_dtypes.bfloat16)
    spec_j, cj = jf.stft_streaming_step(jnp.asarray(hop), jnp.asarray(carry),
                                        jc)
    hop_t = torch.from_numpy(hop.astype(np.float32)).bfloat16()
    carry_t = torch.from_numpy(carry.astype(np.float32)).bfloat16()
    spec_p, cp = tf.stft_streaming_step(hop_t, carry_t, pc)
    assert spec_p.dtype == cp.dtype == torch.bfloat16
    ref = np.asarray(spec_j, np.float32)
    ulp = 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(spec_p.float().numpy(), ref, atol=ulp)
    np.testing.assert_array_equal(cp.float().numpy(), np.asarray(cj, np.float32))
    y_j, oj = jf.istft_streaming_step(spec_j, jnp.asarray(carry), jc)
    y_p, op = tf.istft_streaming_step(
        torch.from_numpy(ref).bfloat16(), carry_t, pc)
    assert y_p.dtype == op.dtype == torch.bfloat16
    y_ref = np.asarray(y_j, np.float32)
    np.testing.assert_allclose(y_p.float().numpy(), y_ref,
                               atol=2.0 ** -7 * np.abs(y_ref).max())


def test_compress_uncompress_match_jax():
    """Both floors: eps^2 inside the sqrt and 1e-30, hit by exact zeros."""
    rng = np.random.default_rng(4)
    spec = rng.standard_normal((2, 33, 5, 2)).astype(np.float32)
    spec[0, :4] = 0.0        # zero bins take the floors
    spec[1, :3] *= 1e-7      # below eps
    c_j = np.asarray(jf.compress(jnp.asarray(spec), 0.3))
    c_p = tf.compress(torch.from_numpy(spec), 0.3)
    np.testing.assert_allclose(c_p.numpy(), c_j, rtol=1e-6, atol=1e-7)
    u_j = np.asarray(jf.uncompress(jnp.asarray(c_j), 0.3))
    u_p = tf.uncompress(torch.tensor(c_j), 0.3)
    np.testing.assert_allclose(u_p.numpy(), u_j, rtol=1e-5, atol=1e-7)
    assert np.isfinite(u_p.numpy()).all()
    x = torch.from_numpy(spec)
    assert tf.compress(x, 1.0) is x and tf.uncompress(x, 1.0) is x
