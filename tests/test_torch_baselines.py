"""PyTorch port of models/fspen.py and models/lisennet.py against the JAX
package.

Tiny widths (FSPEN channels [4, 8, 16], one dual-path block of 8 channels in
2 groups; LiSenNet 8 channels, one block; n_fft 512, the geometry both
models fix), JAX weights moved across by the bridge, FSPEN with random BN
statistics so that fold() does real work. Each model's JAX variables and
chunked stream are made once per file (a cache and a module-scoped
fixture); the JAX steps are jitted, but for LiSenNet's float32 carry test
(see there).

Tolerances: float32 1e-5 absolute against JAX and between the port's own
chunked and per-frame streams (sums of at most a few hundred terms of
order 1; measured on the CPU: at most 5e-7). bfloat16 bounds are stated
at their tests, each beside a control that misses it.

LiSenNet's phase features are discontinuous at +-pi. The offline STFT's
edge frames are symmetric (reflect padding), so their spectra are real and
every phase difference sits on the branch cut: a last-bit difference
between two implementations (or between jitted and eager JAX) flips a
feature from +1 to -1 there, and the time GRU carries it on. The offline
forward test therefore feeds audio whose first and last 257 samples are
silent, which makes the edge frames zero (phase 0 in both packages).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models import get_model as jax_get_model
from fastenhancer_tpu_torch.functional import compress, stft_streaming_chunk
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.ops import gru_scan as tscan
from fastenhancer_tpu_torch.presets import FSPEN, LISENNET
from fastenhancer_tpu_torch.serving import StreamingEngine
from fastenhancer_tpu_torch.utils import cast_floating

from _torch_parity import (assert_trees_close, check_train_forward_runs,
                           flatten_paths, perturb_bn_stats, port_variables,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5
HOP = 256
C = 4
NAMES = ["fspen", "lisennet"]
KWARGS = {
    "fspen": dict(channels=[4, 8, 16],
                  dpe_kwargs=dict(num_blocks=1, channels=8, groups=2)),
    "lisennet": dict(num_channels=8, n_blocks=1),
}
PRESETS = {"fspen": FSPEN, "lisennet": LISENNET}


def _wav(b, frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HOP * frames)) * 0.3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models(name):
    """Both models and JAX's jitted init, made once a name: the init
    compiles once for all of the file's seeds."""
    kw = dict(KWARGS[name], stft_method="matmul")
    jm = jax_get_model(name, **kw)
    return jm, get_model(name, **kw), jax.jit(jm.init)  # eager: ~10 s more


@functools.lru_cache(maxsize=None)
def _setup(name, seed=0):
    """Both models, the JAX variables (FSPEN: random BN statistics) and
    the port's copy."""
    jm, tm, init = _models(name)
    jv = init(jax.random.PRNGKey(seed))
    if name == "fspen":
        jv = perturb_bn_stats(jv, seed)
    jv = jax.tree.map(jnp.asarray, jv)
    return jm, tm, jv, port_variables(jv)


@pytest.fixture(scope="module")
def jax_streams():
    """{name: (wav [3, 14 hops], JAX's chunked stream of it)}: the JAX
    stream traces its scan once per model, so the two tests that read it
    share it."""
    out = {}
    for name in NAMES:
        jm, _, jv, _ = _setup(name)
        wav = _wav(3, 14, seed=2)
        out[name] = wav, np.asarray(jm.stream(jm.fold(jv), jnp.asarray(wav),
                                              chunk_frames=C))
    return out


# ---------------------------------------------------------------------------
# init, fold, offline forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_tree_matches_jax(name):
    """Same paths and shapes as the JAX init, at the tiny widths and at the
    preset's (the JAX init's parameter count), GRU weights within torch's
    default bound."""
    for kw in (KWARGS[name], PRESETS[name]):
        jm, tm = jax_get_model(name, **kw), get_model(name, **kw)
        j = flatten_paths(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
        t = flatten_paths(tm.init(torch.Generator().manual_seed(0), "cpu"))
        assert j.keys() == t.keys(), sorted(set(j) ^ set(t))
        for path in j:
            assert tuple(t[path].shape) == j[path].shape, path
    rnn = (("params", "dpe_blocks", "2", "inter_rnn", "7", "weight_hh")
           if name == "fspen" else
           ("params", "blocks", "1", "inter_rnn", "weight_hh"))
    assert t[rnn].abs().max() <= 1 / t[rnn].shape[1] ** 0.5


@pytest.mark.parametrize("name", NAMES)
def test_fold_matches_jax(name):
    jm, tm, jv, tv = _setup(name)
    folded = tm.fold(tv)
    assert_trees_close(folded, jm.fold(jv), atol=ATOL)
    if name == "lisennet":
        assert folded is tv  # nothing to fold


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("folded", [False, True])
def test_forward_matches_jax(name, folded):
    """The offline eval forward, folded or not, on 2 x 10 hops whose edge
    frames are silent (see the module docstring)."""
    jm, tm, jv, tv = _setup(name)
    if folded:
        jv, tv = jm.fold(jv), tm.fold(tv)
    wav = _wav(2, 10, seed=3)
    wav[:, :257] = wav[:, -257:] = 0.0
    wt, st, _ = tm.forward(tv, torch.tensor(wav))
    wj, sj, _ = jax.jit(functools.partial(jm.forward, train=False))(
        jv, jnp.asarray(wav))
    assert tuple(st.shape) == sj.shape
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=ATOL)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_streaming_chunk_carries_match_jax(name):
    """Three streaming_chunk calls of 4, 3 and 4 frames (the first a
    streaming_step given 4 hops), carries fed back on both sides: every
    output and the whole final carry within 1e-5 of JAX's (LiSenNet's
    carried phase is float32 in the port, as it is in a float32 JAX
    carry). LiSenNet's JAX steps run eagerly: its IFD feature takes sin
    and cos of up to ~804 rad, where a float32 ulp is 6e-5, and jitted XLA
    computes them another way than eager XLA (2e-5 apart on IFD/pi, which
    the encoder's normalisation carries to 3e-5 on its caches; the port is
    within 1.2e-7 of the eager form)."""
    jm, tm, jv, tv = _setup(name, seed=3)
    wav = _wav(2, 11, seed=4)
    cj = jm.init_streaming_carry(2)
    ct = tm.init_streaming_carry(2, torch.float32, "cpu")
    step_j = (jax.jit(jm.streaming_chunk) if name == "fspen"
              else jm.streaming_chunk)
    steps = (tm.streaming_step, tm.streaming_chunk, tm.streaming_chunk)
    start = 0
    for frames, step_t in zip((4, 3, 4), steps):
        x = wav[:, start * HOP:(start + frames) * HOP]
        start += frames
        cj, y_j = step_j(jv, cj, jnp.asarray(x))
        ct, y_t = step_t(tv, ct, torch.tensor(x))
        assert tuple(y_t.shape) == (2, frames * HOP)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
    assert_trees_close(ct, cj, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_chunked_stream_matches_jax_and_per_frame(name, jax_streams):
    """stream(chunk_frames=4) over 14 frames of 3 streams (folded): the tail
    cut to 12 frames as in JAX, within 1e-5 of JAX's chunked stream and of
    the port's own per-frame stream."""
    jm, tm, _, tv = _setup(name)
    folded = tm.fold(tv)
    wav, y_j = jax_streams[name]
    y_t = tm.stream(folded, torch.tensor(wav), chunk_frames=C)
    assert tuple(y_t.shape) == y_j.shape == (3, 12 * HOP)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=ATOL)
    y_frames = tm.stream(folded, torch.tensor(wav))
    assert tuple(y_frames.shape) == (3, 14 * HOP)
    np.testing.assert_allclose(y_t.numpy(), y_frames[:, :12 * HOP].numpy(),
                               atol=ATOL)


def _time_carries(name, carry):
    """The time GRUs' carried states in launch order."""
    h = carry["h"]
    return ([s for block in h for s in block] if name == "fspen"
            else list(h["dpr_rnn"]))


@pytest.mark.parametrize("name", NAMES)
def test_every_gru_is_a_scan_and_time_scans_carry(name, monkeypatch):
    """At the preset's widths, two chunks of 4 frames of 2 streams: FSPEN
    runs 2 + 8 scans a block (the intra biGRU's two directions over the 32
    bins, N = C*B rows, then the 8 groups' time GRUs over the C frames, N =
    B*4), 30 a chunk; LiSenNet 3 a block (the intra biGRU, then the time
    GRU, N = B*32), 6 a chunk. Each time scan starts from its carried state
    and the new carry is its h_T."""
    tm = get_model(name, **PRESETS[name], stft_method="matmul")
    tv = tm.init(torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = tscan.gru_scan

    def spy(x_proj, h0, w_hh, b_hh):
        out = real(x_proj, h0, w_hh, b_hh)
        calls.append((tuple(x_proj.shape), h0.clone(), out[1]))
        return out

    monkeypatch.setattr(tscan, "gru_scan", spy)
    b = 2
    if name == "fspen":  # 3 blocks of 8 groups, H = 16, 4 bins a group
        kinds = (["intra"] * 2 + ["time"] * 8) * 3
        intra, time = (32, C * b, 3 * 16), (C, b * 4, 3 * 16)
    else:  # 2 blocks, H = 12 a direction, 24 in time
        kinds = ["intra", "intra", "time"] * 2
        intra, time = (32, C * b, 3 * 12), (C, b * 32, 3 * 24)
    wav = torch.tensor(_wav(b, 2 * C, seed=6))
    carry = tm.init_streaming_carry(b, torch.float32, "cpu")
    for i in range(2):
        h_before = [h.clone() for h in _time_carries(name, carry)]
        calls.clear()
        carry, _ = tm.streaming_chunk(tv, carry,
                                      wav[:, i * C * HOP:(i + 1) * C * HOP])
        assert len(calls) == len(kinds) == (30 if name == "fspen" else 6)
        time_calls = [c for c, k in zip(calls, kinds) if k == "time"]
        assert all(c[0] == intra for c, k in zip(calls, kinds)
                   if k == "intra")
        assert all(torch.count_nonzero(c[1]) == 0 for c, k in
                   zip(calls, kinds) if k == "intra")  # no state across bins
        for (shape, h0, h_t), want_h0, new_h in zip(
                time_calls, h_before, _time_carries(name, carry)):
            assert shape == time
            assert torch.equal(h0, want_h0)
            assert torch.equal(new_h, h_t)
        if i:  # the second chunk starts from a state the first one left
            assert all(h.abs().max() > 0 for h in h_before)


@pytest.mark.parametrize("name", NAMES)
def test_engine_slot_isolation_with_a_reused_slot(name):
    """A capacity-2 engine (unfused, float32): a and b together for 2
    ticks, b leaves, c takes b's slot for 4 ticks (its last hop silence).
    Every stream's raw output equals its isolated stream() run within
    1e-5."""
    _, tm, _, tv = _setup(name)
    folded = tm.fold(tv)
    rng = np.random.default_rng(5)
    wav = {k: rng.uniform(-0.3, 0.3, n * HOP).astype(np.float32)
           for k, n in (("a", 6), ("b", 2), ("c", 3))}
    engine = StreamingEngine(tm, folded, capacity=2, device="cpu")
    outs = {k: [] for k in wav}
    ha, hb = engine.open_stream(), engine.open_stream()
    for i in range(2):
        o = engine.tick({ha: wav["a"][i * HOP:(i + 1) * HOP],
                         hb: wav["b"][i * HOP:(i + 1) * HOP]})
        outs["a"].append(o[ha])
        outs["b"].append(o[hb])
    engine.close_stream(hb)
    hc = engine.open_stream()
    assert engine._slot_of[hc] == 1  # really reusing the freed slot
    for i in range(2, 6):
        c = wav["c"][(i - 2) * HOP:(i - 1) * HOP]
        o = engine.tick({ha: wav["a"][i * HOP:(i + 1) * HOP],
                         hc: c if len(c) else np.zeros(HOP, np.float32)})
        outs["a"].append(o[ha])
        outs["c"].append(o[hc])
    for k, chunks in outs.items():
        y = np.concatenate(chunks)
        x = np.zeros(len(y), np.float32)
        x[:min(len(y), len(wav[k]))] = wav[k][:len(y)]
        want = tm.stream(folded, torch.tensor(x[None]))[0].numpy()
        np.testing.assert_allclose(y, want, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_silence_stays_finite_in_both_packages(name):
    """The engine feeds silence to idle slots: a silent stream (FSPEN's mask
    divides by the full mask's magnitude) and a silent offline forward stay
    finite in both packages, and agree."""
    jm, tm, jv, tv = _setup(name)
    jf, tf = jm.fold(jv), tm.fold(tv)
    wav = np.zeros((2, 5 * HOP), np.float32)
    y_t = tm.stream(tf, torch.tensor(wav)).numpy()
    y_j = np.asarray(jax.jit(jm.stream)(jf, jnp.asarray(wav)))
    w_t, _, _ = tm.forward(tf, torch.tensor(wav))
    w_j, _, _ = jax.jit(functools.partial(jm.forward, train=False))(
        jf, jnp.asarray(wav))
    for y in (y_t, y_j, w_t.numpy(), np.asarray(w_j)):
        assert np.isfinite(y).all()
    np.testing.assert_allclose(y_t, y_j, atol=ATOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_training_and_a_fused_engine_raise(name):
    """Training runs (its parity with JAX: tests/test_torch_train_
    baselines.py); a fused engine raises: neither model has a stack
    plan."""
    _, tm, _, tv = _setup(name)
    wav = torch.tensor(_wav(1, 4, seed=7))
    check_train_forward_runs(tm, tv, wav, moves_stats=name == "fspen")
    with pytest.raises(ValueError, match="no fused stack plan"):
        StreamingEngine(tm, tv, capacity=2, fused=True, device="cpu")


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

def test_fspen_bf16_matches_jax_and_a_dropped_carry_misses():
    """bfloat16: three chunks of 4 frames against JAX's bf16
    streaming_chunk. The port keeps each time GRU's state in float32 over a
    chunk (JAX rounds it every frame, and runs its own bf16 casts), so the
    bounds are measured: every output chunk within 2^-4 of its peak
    (measured at most 0.0283 on seeds 1-5; JAX's own bf16 against its f32
    stream: 0.029), the final GRU carries within 2^-5 of their peak
    (measured at most 0.0095). Control: the same stream with the carries
    dropped (zeroed) before the last chunk misses the carry bound (measured
    at least 0.127 of the peak)."""
    jm, tm, jv, tv = _setup("fspen", seed=2)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jv)
    tb = cast_floating(tv, torch.bfloat16)
    wav = _wav(3, 3 * C, seed=2)
    cj = jm.init_streaming_carry(3, jnp.bfloat16)
    ct = tm.init_streaming_carry(3, torch.bfloat16, "cpu")
    step_j = jax.jit(jm.streaming_chunk)
    for i in range(3):
        x = wav[:, i * C * HOP:(i + 1) * C * HOP]
        if i == 2:
            dropped = dict(ct, h=[[torch.zeros_like(h) for h in block]
                                  for block in ct["h"]])
        cj, y_j = step_j(jb, cj, jnp.asarray(x, jnp.bfloat16))
        ct, y_t = tm.streaming_chunk(tb, ct, torch.tensor(x).bfloat16())
        assert y_t.dtype == torch.bfloat16
        y_j = np.asarray(y_j.astype(jnp.float32))
        np.testing.assert_allclose(y_t.float().numpy(), y_j,
                                   atol=2 ** -4 * np.abs(y_j).max())
    h_j = np.concatenate([np.asarray(h.astype(jnp.float32))
                          for h in jax.tree.leaves(cj["h"])])
    tol = 2 ** -5 * np.abs(h_j).max()

    def flat(carry):
        return torch.cat([h.float() for h in _time_carries("fspen", carry)
                          ]).numpy()

    assert all(h.dtype == torch.bfloat16 for h in _time_carries("fspen", ct))
    assert np.abs(flat(ct) - h_j).max() <= tol
    control, _ = tm.streaming_chunk(tb, dropped, torch.tensor(
        wav[:, 2 * C * HOP:]).bfloat16())
    assert np.abs(flat(control) - h_j).max() > tol


def test_fspen_bf16_mask_keeps_the_last_sum_and_its_bias_together():
    """FSPEN's mask divides by the full-band mask's magnitude. In bf16,
    cuDNN rounds the last ConvTranspose's sum before it adds the bias: a
    sum of -(1 + 2^-6 + 2^-14) rounds to -(1 + 2^-6) and cancels a bias of
    1 + 2^-6 to exactly 0 in both channels (here rebuilt with a bias-free
    bf16 ConvTranspose and a bf16 add), and the division gives a NaN (seen
    on the H100 at 256 streams). The port runs that ConvTranspose and the
    mask in float32: finite, and equal to the float32 model's mask."""
    _, tm, _, _ = _setup("fspen")
    cin, k = tm.channels[0], tm.kernel_size[0]
    a = 1 + 2 ** -7  # both bf16 numbers; a * a is not
    x = torch.zeros(1, 128, cin)
    x[0, 0, 0] = a
    w = torch.zeros(cin, 2, k)
    w[0, :, 2] = -a  # tap 2 of input 0 lands on output bin 0
    convt = {"weight": w, "bias": torch.full((2,), 1 + 2 ** -6)}
    rng = np.random.default_rng(9)
    spec = torch.tensor(rng.standard_normal((1, 257, 1, 2)),
                        dtype=torch.float32)
    mask_sub = torch.tensor(rng.uniform(0, 1, (1, 257, 1, 1)),
                            dtype=torch.float32)
    xb, cb = x.bfloat16(), {n: v.bfloat16() for n, v in convt.items()}
    rounded = torch.nn.functional.conv_transpose1d(
        xb.transpose(1, 2), cb["weight"], stride=2, padding=(k - 2) // 2,
        output_padding=1).transpose(1, 2) + cb["bias"]
    assert torch.equal(rounded[0, 0], torch.zeros(2, dtype=torch.bfloat16))
    got = tm._mask(cb, xb, spec.bfloat16(), mask_sub.bfloat16())
    want = tm._mask(convt, x, spec.bfloat16().float(),
                    mask_sub.bfloat16().float())
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert torch.equal(got, want.bfloat16())


def _bf16_spectrum(seed):
    """A compressed bf16 streaming spectrum [2, 257, 6, 2] (the port's STFT
    of bf16 audio), as float32 numpy, and a last-frame phase [2, 1, 257]."""
    _, tm, _, _ = _setup("lisennet")
    wav = torch.tensor(_wav(2, 6, seed)).bfloat16()
    carry = tm.init_streaming_carry(2, torch.bfloat16, "cpu")
    spec, _ = stft_streaming_chunk(wav, carry["stft"], tm.stft_cfg)
    spec = compress(spec, tm.input_compression).float().numpy()
    rng = np.random.default_rng(seed)
    prev = rng.uniform(-np.pi, np.pi, (2, 1, 257)).astype(np.float32)
    return spec, prev


def test_lisennet_jax_bf16_ifd_is_rounding_noise():
    """The divergence the port fixes: JAX's bf16 _features against its own
    float32 _features of the same bf16 spectrum. Its IFD subtracts
    2 pi (hop / n_fft) k, up to ~804 rad, where a bf16 ulp is 4 rad: IFD/pi
    is off by a mean of more than 0.1 on a [-1, 1] feature (0.376 at the
    full widths, measured on the CPU)."""
    jm, _, _, _ = _setup("lisennet")
    spec, prev = _bf16_spectrum(8)
    f32, _ = jm._features(jnp.asarray(spec), jnp.asarray(prev))
    bf16, _ = jm._features(jnp.asarray(spec, jnp.bfloat16),
                           jnp.asarray(prev, jnp.bfloat16))
    ifd_err = np.abs(np.asarray(bf16[..., 2].astype(jnp.float32))
                     - np.asarray(f32[..., 2]))
    assert ifd_err.mean() > 0.1


def test_lisennet_port_bf16_features_are_its_f32_features_rounded():
    """The port computes _features in float32 from the bf16 spectrum and
    rounds once: its bf16 features are exactly its float32 features of the
    same spectrum rounded to bf16, and within bf16 rounding (2^-8 of each
    value, plus 1e-6 for the two packages' atan2) of JAX's float32
    features; the carried phase stays float32."""
    jm, tm, _, _ = _setup("lisennet")
    spec, prev = _bf16_spectrum(8)
    bf16, pha = tm._features(torch.tensor(spec).bfloat16(), torch.tensor(prev))
    f32, pha32 = tm._features(torch.tensor(spec), torch.tensor(prev))
    assert bf16.dtype == torch.bfloat16 and pha.dtype == torch.float32
    assert torch.equal(bf16, f32.bfloat16()) and torch.equal(pha, pha32)
    want, _ = jm._features(jnp.asarray(spec), jnp.asarray(prev))
    want = np.asarray(want)
    assert np.all(np.abs(bf16.float().numpy() - want)
                  <= 2 ** -8 * np.abs(want) + 1e-6)


def test_lisennet_bf16_stream_holds_to_jax_f32_where_jax_bf16_misses():
    """The port's bf16 chunked stream (float32 features) against JAX's
    float32 stream: each of three chunks of 4 frames within 2^-4 of the
    peak (measured at most 0.030 on seeds 1-5). Control: JAX's own bf16
    stream, whose IFD feature is rounding noise, misses that bound on at
    least one chunk (measured 0.075-0.133 at its worst chunk, seeds 1-5)."""
    jm, tm, jv, tv = _setup("lisennet", seed=1)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jv)
    tb = cast_floating(tv, torch.bfloat16)
    wav = _wav(3, 3 * C, seed=1)
    cf = jm.init_streaming_carry(3)
    cj = jm.init_streaming_carry(3, jnp.bfloat16)
    ct = tm.init_streaming_carry(3, torch.bfloat16, "cpu")
    step_j = jax.jit(jm.streaming_chunk)
    port_err, jax_err = [], []
    for i in range(3):
        x = wav[:, i * C * HOP:(i + 1) * C * HOP]
        cf, y_f = step_j(jv, cf, jnp.asarray(x))
        cj, y_j = step_j(jb, cj, jnp.asarray(x, jnp.bfloat16))
        ct, y_t = tm.streaming_chunk(tb, ct, torch.tensor(x).bfloat16())
        peak = np.abs(np.asarray(y_f)).max()
        port_err.append(np.abs(y_t.float().numpy() - y_f).max() / peak)
        jax_err.append(np.abs(np.asarray(y_j.astype(jnp.float32)) - y_f
                              ).max() / peak)
    assert max(port_err) <= 2 ** -4
    assert max(jax_err) > 2 ** -4
