"""Chunked streaming in the PyTorch port against the JAX package.

`stft_streaming_chunk` / `istft_streaming_chunk`, and `stream(chunk_frames=C)`
/ `streaming_chunk` of the seven served families, with tiny configs and JAX
weights moved across by the bridge. Tolerances: float32 port against JAX
1e-5 absolute (stream outputs, carries, spectra); float32 chunked against
the port's own per-frame stream 1e-4; bfloat16 2^-5 of the peak (a few bf16
ulps), stated and checked with a control at the test.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu import functional as jf
from fastenhancer_tpu.models import get_model as jax_get_model
from fastenhancer_tpu_torch import functional as tf
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.ops import gru_scan as tscan
from fastenhancer_tpu_torch.utils import cast_floating

from _torch_parity import (TINY_KWARGS, assert_trees_close, perturb_bn_stats,
                           perturb_norms, port_variables,
                           torch_one_thread)  # noqa: F401
from test_model_variants import DPRNN_KWARGS

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5        # float32, the port against JAX
FRAME_ATOL = 1e-4  # float32, chunked against per-frame (the port)
BF16_REL = 2 ** -5
C = 4

TIME_KERNEL_KWARGS = dict(
    channels=12, kernel_size_freq=[4, 3], kernel_size_time=3, stride=4,
    rnnformer_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2,
                          positional_embedding="train"),
    n_fft=128, hop_size=64, win_size=128, window="hann",
    weight_norm=True, pre_post_init="linear_fixed",
)
# lookbehind 5 < the 14 frames streamed, so the band slides past the cache
DPT_KWARGS = dict(
    channels=12, kernel_size=[4, 3], stride=4,
    dpt_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2,
                    lookbehind=5, positional_embedding="train"),
    n_fft=128, hop_size=64, win_size=128, window="hann",
    weight_norm=True, pre_post_init="linear_fixed",
)
FAMILIES = {
    "fastenhancer.default": TINY_KWARGS,
    "fastenhancer.conv_stft": TINY_KWARGS,
    "fastenhancer.dptransformer": DPT_KWARGS,
    "fastenhancer.dprnn": DPRNN_KWARGS,
    "fastenhancer.ln": TINY_KWARGS,
    "fastenhancer.time_kernel": TIME_KERNEL_KWARGS,
    "bsrnn": dict(num_channels=8, num_layers=2),
}
# the families whose blocks run a time GRU (one gru_scan each in eval)
GRU_FAMILIES = ["fastenhancer.default", "fastenhancer.conv_stft",
                "fastenhancer.dprnn", "fastenhancer.ln",
                "fastenhancer.time_kernel"]


@functools.lru_cache(maxsize=None)
def _setup(name, seed=1):
    """Both models, JAX variables (random BN statistics; the ln ablation's
    norms drawn away from init) and the port's copy, made once a (name,
    seed) in this file (JAX's eager init of BSRNN's 31 bands alone takes
    ~10 s)."""
    kw = dict(FAMILIES[name], stft_method="matmul")
    jm, tm = jax_get_model(name, **kw), get_model(name, **kw)
    jv = jm.init(jax.random.PRNGKey(seed))
    if name == "fastenhancer.ln":
        jv = {"params": perturb_norms(jv["params"], seed),
              "stats": jv["stats"]}
    else:
        jv = perturb_bn_stats(jv, seed)
    jv = jax.tree.map(jnp.asarray, jv)
    return jm, tm, jv, port_variables(jv)


def _wav(b, frames, hop, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hop * frames)) * 0.3).astype(np.float32)


# ---------------------------------------------------------------------------
# the DSP layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("n_fft,hop", [(128, 64), (512, 100)])
def test_stft_chunks_match_jax_and_single_hops(method, n_fft, hop):
    """Three chunks of 4 hops through both packages' chunk functions,
    carries fed back on both sides: spectra, samples and carries within
    1e-5 of JAX's, and of the port's 4 single-hop steps. Hop 100 does not
    divide n_fft 512, so the overlap-add takes its scatter path."""
    jc = jf.STFTConfig(n_fft=n_fft, hop_size=hop, method=method)
    pc = tf.STFTConfig(n_fft=n_fft, hop_size=hop, method=method)
    rng = np.random.default_rng(n_fft + hop)
    wav = (rng.standard_normal((2, hop * C * 3)) * 0.1).astype(np.float32)
    sj = jf.init_stft_carry(jc, 2)
    oj = jf.init_istft_carry(jc, 2)
    sp = tf.init_stft_carry(pc, 2, torch.float32, "cpu")
    op = tf.init_istft_carry(pc, 2, torch.float32, "cpu")
    s1, o1 = sp.clone(), op.clone()
    for i in range(3):
        x = wav[:, i * hop * C:(i + 1) * hop * C]
        spec_j, sj = jf.stft_streaming_chunk(jnp.asarray(x), sj, jc)
        spec_p, sp = tf.stft_streaming_chunk(torch.tensor(x), sp, pc)
        assert tuple(spec_p.shape) == (2, pc.n_freq, C, 2)
        np.testing.assert_allclose(spec_p.numpy(), np.asarray(spec_j),
                                   atol=ATOL)
        np.testing.assert_allclose(sp.numpy(), np.asarray(sj), atol=ATOL)
        y_j, oj = jf.istft_streaming_chunk(spec_j, oj, jc)
        y_p, op = tf.istft_streaming_chunk(spec_p, op, pc)
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=ATOL)
        np.testing.assert_allclose(op.numpy(), np.asarray(oj), atol=ATOL)
        # the same frames as C single-hop steps
        for k in range(C):
            spec_1, s1 = tf.stft_streaming_step(
                torch.tensor(x[:, k * hop:(k + 1) * hop]), s1, pc)
            np.testing.assert_allclose(spec_1.numpy(),
                                       spec_p[:, :, k].numpy(), atol=ATOL)
            y_1, o1 = tf.istft_streaming_step(spec_p[:, :, k], o1, pc)
            np.testing.assert_allclose(y_1.numpy(),
                                       y_p[:, k * hop:(k + 1) * hop].numpy(),
                                       atol=ATOL)


def test_stft_chunk_bf16_casts_match_jax():
    """bfloat16 in: the spectra and samples come back in bfloat16, the
    analysis carry in the input's dtype, as in JAX (one bf16 ulp of the
    peak)."""
    jc = jf.STFTConfig(n_fft=128, hop_size=64, method="matmul")
    pc = tf.STFTConfig(n_fft=128, hop_size=64, method="matmul")
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 64 * C)) * 0.3).astype(np.float32)
    spec_j, sj = jf.stft_streaming_chunk(
        jnp.asarray(x, jnp.bfloat16), jf.init_stft_carry(jc, 2, jnp.bfloat16),
        jc)
    spec_p, sp = tf.stft_streaming_chunk(
        torch.tensor(x).bfloat16(),
        tf.init_stft_carry(pc, 2, torch.bfloat16, "cpu"), pc)
    y_j, oj = jf.istft_streaming_chunk(
        spec_j, jf.init_istft_carry(jc, 2, jnp.bfloat16), jc)
    y_p, op = tf.istft_streaming_chunk(
        spec_p, tf.init_istft_carry(pc, 2, torch.bfloat16, "cpu"), pc)
    for got, want in ((spec_p, spec_j), (sp, sj), (y_p, y_j), (op, oj)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2 ** -7 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the seven families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FAMILIES))
def test_chunked_stream_matches_jax_and_per_frame(name):
    """stream(chunk_frames=4) over 14 frames of 3 streams: the tail is cut
    to 12 frames as in JAX; the output matches JAX's chunked stream within
    1e-5 and the port's own per-frame stream within 1e-4."""
    jm, tm, jv, tv = _setup(name)
    hop = tm.hop_size
    wav = _wav(3, 14, hop, seed=2)
    y_j = np.asarray(jm.stream(jv, jnp.asarray(wav), chunk_frames=C))
    y_t = tm.stream(tv, torch.tensor(wav), chunk_frames=C)
    assert tuple(y_t.shape) == y_j.shape == (3, 12 * hop)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=ATOL)
    y_frames = tm.stream(tv, torch.tensor(wav))
    assert tuple(y_frames.shape) == (3, 14 * hop)
    np.testing.assert_allclose(y_t.numpy(), y_frames[:, :12 * hop].numpy(),
                               atol=FRAME_ATOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_streaming_chunk_carries_match_jax(name):
    """Three streaming_chunk steps of 4, 3 and 4 frames, carries fed back on
    both sides: every output chunk and the whole final carry (STFT caches,
    GRU or LSTM states, the dpt's K/V, time_kernel's conv frame caches)
    within 1e-5 of JAX's."""
    jm, tm, jv, tv = _setup(name, seed=3)
    hop = tm.hop_size
    wav = _wav(2, 11, hop, seed=4)
    cj = jm.init_streaming_carry(2)
    ct = tm.init_streaming_carry(2, torch.float32, "cpu")
    step_j = jax.jit(jm.streaming_chunk)
    start = 0
    for frames in (4, 3, 4):
        x = wav[:, start * hop:(start + frames) * hop]
        start += frames
        cj, y_j = step_j(jv, cj, jnp.asarray(x))
        ct, y_t = tm.streaming_chunk(tv, ct, torch.tensor(x))
        assert tuple(y_t.shape) == (2, frames * hop)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
    assert_trees_close(ct, cj, atol=ATOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_fused_plan_with_chunks_raises(name):
    """A fused plan implies one frame a step: with chunk_frames > 1 both
    packages raise ValueError, and the plan alone still streams."""
    jm, tm, jv, tv = _setup(name)
    jf_, tf_ = jm.fold(jv), tm.fold(tv)
    wav = _wav(2, 4, tm.hop_size, seed=5)
    plan = tm.build_stack_plan(tf_)
    with pytest.raises(ValueError, match="fused_plan"):
        tm.stream(tf_, torch.tensor(wav), chunk_frames=2, fused_plan=plan)
    with pytest.raises(ValueError, match="fused_plan"):
        jm.stream(jf_, jnp.asarray(wav), chunk_frames=2,
                  fused_plan=jm.build_stack_plan(jf_))
    assert tm.stream(tf_, torch.tensor(wav), fused_plan=plan).shape[1] \
        == wav.shape[1]


@pytest.mark.parametrize("name", GRU_FAMILIES)
def test_chunk_runs_each_time_gru_as_one_scan_from_the_carry(name,
                                                             monkeypatch):
    """Each chunk runs every block's time GRU as one gru_scan over its C
    frames, N = B*F' rows, from that block's carried state as h0, and the
    block's new carry is the scan's h_T."""
    _, tm, _, tv = _setup(name)
    calls = []
    real = tscan.gru_scan

    def spy(x_proj, h0, w_hh, b_hh):
        out = real(x_proj, h0, w_hh, b_hh)
        calls.append((tuple(x_proj.shape), h0.clone(), out[1]))
        return out

    monkeypatch.setattr(tscan, "gru_scan", spy)
    hop, b = tm.hop_size, 2
    wav = torch.tensor(_wav(b, 2 * C, hop, seed=6))
    carry = tm.init_streaming_carry(b, torch.float32, "cpu")

    def block_h(c):
        h = c["h"]
        return h["h"] if isinstance(h, dict) else h  # time_kernel nests it

    for i in range(2):
        h_before = [h.clone() for h in block_h(carry)]
        calls.clear()
        carry, _ = tm.streaming_chunk(tv, carry,
                                      wav[:, i * C * hop:(i + 1) * C * hop])
        assert len(calls) == tm.num_blocks
        for (shape, h0, h_t), want_h0, new_h in zip(calls, h_before,
                                                    block_h(carry)):
            assert shape == (C, b * tm.block_freq, 3 * tm.block_channels)
            assert torch.equal(h0, want_h0)
            assert torch.equal(new_h, h_t)
        if i:  # the second chunk starts from a state the first one left
            assert all(h.abs().max() > 0 for h in h_before)


def test_chunked_bf16_matches_jax_and_a_dropped_state_misses():
    """bfloat16, FastEnhancer default: three chunks of 4 frames against JAX's
    bf16 streaming_chunk. Tolerance 2^-5 of the peak on every output chunk
    and on the final GRU carries (the port keeps the state in float32
    within a chunk and rounds it once a chunk; JAX rounds it every frame:
    a fraction of a bf16 ulp a step, measured at most 1.0e-2 of the peak
    on the carries over seeds 1-7). Control: the same stream with the GRU
    carries dropped (zeroed) before the last chunk misses the bound on
    the final carries (measured at least 0.18 of the peak on seeds 1-7)."""
    jm, tm, jv, tv = _setup("fastenhancer.default", seed=2)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jv)
    tb = cast_floating(tv, torch.bfloat16)
    hop = tm.hop_size
    wav = _wav(3, 3 * C, hop, seed=2)
    cj = jm.init_streaming_carry(3, jnp.bfloat16)
    ct = tm.init_streaming_carry(3, torch.bfloat16, "cpu")
    step_j = jax.jit(jm.streaming_chunk)
    for i in range(3):
        x = wav[:, i * C * hop:(i + 1) * C * hop]
        if i == 2:
            dropped = dict(ct, h=[torch.zeros_like(h) for h in ct["h"]])
        cj, y_j = step_j(jb, cj, jnp.asarray(x, jnp.bfloat16))
        ct, y_t = tm.streaming_chunk(tb, ct, torch.tensor(x).bfloat16())
        assert y_t.dtype == torch.bfloat16
        y_j = np.asarray(y_j.astype(jnp.float32))
        np.testing.assert_allclose(y_t.float().numpy(), y_j,
                                   atol=BF16_REL * np.abs(y_j).max())
    h_j = np.concatenate([np.asarray(h.astype(jnp.float32))
                          for h in cj["h"]])
    tol = BF16_REL * np.abs(h_j).max()
    h_t = torch.cat(ct["h"]).float().numpy()
    assert all(h.dtype == torch.bfloat16 for h in ct["h"])
    assert np.abs(h_t - h_j).max() <= tol
    control, _ = tm.streaming_chunk(tb, dropped, torch.tensor(
        wav[:, 2 * C * hop:]).bfloat16())
    h_c = torch.cat(control["h"]).float().numpy()
    assert np.abs(h_c - h_j).max() > tol
