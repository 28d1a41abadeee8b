"""The whole-frame op (fastenhancer_tpu_torch/ops/fused_frame.py) and
`Model.streaming_step_fused_frame`.

The plan against the JAX package's `plan_frame`, the plain version against
its Pallas kernel (interpret mode, as tests/test_ops_pallas.py runs it), and
the whole-frame streaming step against the unfused `streaming_step` of both
packages, on the cases of tests/test_ops_pallas.py:311-322. The CUDA kernel
itself is tested on the card by tests/test_torch_cuda_kernels.py.

Tolerances: float32 1e-5 absolute (sums of at most a few hundred terms of
order 1); bfloat16 vs the Pallas kernel 2^-5 of the largest magnitude (a
few bf16 ulps: a sum on a rounding boundary can round either way).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.fastenhancer.default import Model as JModel
from fastenhancer_tpu.ops import fused_frame as jframe
from fastenhancer_tpu_torch import nn as fnn
from fastenhancer_tpu_torch.models.fastenhancer.default import Model as TModel
from fastenhancer_tpu_torch.models.fastenhancer.dptransformer import (
    Model as TDptModel)
from fastenhancer_tpu_torch.ops import fused_frame as tframe

from _torch_parity import (as_np, perturb_bn_stats, port_variables,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5
# tests/test_ops_pallas.py::_frame_model
FRAME_KWARGS = dict(
    channels=12, kernel_size=[8, 3, 3], stride=4,
    rnnformer_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2,
                          positional_embedding="train"),
    n_fft=128, hop_size=64, win_size=128, window="hann",
    weight_norm=True, pre_post_init="linear_fixed", activation="SiLU",
    stft_method="matmul",
)
CASES = {
    "plain": {},
    "sigmoid-resnet": dict(mask="sigmoid", resnet=True),
    "attn_bias-3-blocks": dict(rnnformer_kwargs=dict(
        num_blocks=3, channels=8, freq=8, num_heads=2,
        positional_embedding="train", attn_bias=True)),
    "tanh-k5": dict(mask="tanh", kernel_size=[8, 5]),
}


def _models(**over):
    kw = dict(FRAME_KWARGS, **over)
    return JModel(**kw), TModel(**kw)


def _folded(jm, seed):
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(seed)),
                                       seed))
    jf = jm.fold(jv)
    return jf, port_variables(jf)


def _step_kwargs(m):
    return dict(num_blocks=m.num_blocks, num_heads=m.rf.num_heads,
                n_enc=len(m.kernel_size) - 1,
                enc_ks=tuple(m.kernel_size[1:]), f_enc=m.freq,
                block_freq=m.block_freq, stride=m.stride, resnet=m.resnet,
                mask=m.mask_name)


def _inputs(m, b, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, m.freq + 1, 2 * m.stride)).astype(np.float32)
    h = (rng.standard_normal((m.num_blocks, b * m.block_freq,
                              m.block_channels)) * 0.5).astype(np.float32)
    return x, h


def test_plan_matches_jax_plan():
    """Every frame-plan array equals JAX's (biases without JAX's leading
    unit axes): conv taps, the transposed resample linears, the split
    decoder weights and the ConvTranspose phases."""
    jm, tm = _models(**CASES["tanh-k5"])
    jf, tf = _folded(jm, 0)
    jp, tp_ = jm.build_frame_plan(jf), tm.build_frame_plan(tf)
    for key in tframe.frame_plan_keys(len(jm.kernel_size) - 1):
        want = np.asarray(jp[key])
        got = as_np(tp_[key])
        np.testing.assert_array_equal(got, want.reshape(got.shape),
                                      err_msg=key)
    stack = tm.build_stack_plan(tf)
    for key, value in stack.items():
        assert torch.equal(tp_["stack"][key], value), key
    bf16 = tm.build_frame_plan(tf, dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for k, v in bf16.items()
               if k != "stack")


def test_convt_phases_and_skip_sums_match_the_unfused_decoder():
    """The two places an index slip hides: the ConvTranspose phase split
    and the split-weight skip sums, each against the layer it replaces."""
    jm, tm = _models()
    _, tf = _folded(jm, 1)
    plan = tm.build_frame_plan(tf)
    p = tf["params"]
    rng = np.random.default_rng(1)
    b, f, c, s = 3, tm.freq, tm.channels, tm.stride
    y = torch.tensor(rng.standard_normal((b, f, c)).astype(np.float32))
    skip = torch.tensor(rng.standard_normal((b, f, c)).astype(np.float32))
    # the phase split against conv_transpose1d_cl
    want = tm._scaled_convt(p["dec_post"]["convt"], y)        # [B, F*s, 2]
    zeros = y.new_zeros(b, 1, c)
    prev, nxt = torch.cat([zeros, y[:, :-1]], 1), torch.cat([y[:, 1:], zeros],
                                                            1)
    phases = [y @ plan["w_convt_a"][r]
              + (prev if r < s // 2 else nxt) @ plan["w_convt_b"][r]
              for r in range(s)]
    got = (torch.cat(phases, -1) + plan["b_convt"]).reshape(b, f * s, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    # each split-weight sum against a 1x1 conv of the concatenation
    for i, dp in enumerate(p["decoder"]):
        want = fnn.conv1d_cl(dp["conv1"], torch.cat([y, skip], -1))
        got = (y @ plan[f"w_dec{i}_x"] + skip @ plan[f"w_dec{i}_s"]
               + plan[f"b_dec{i}_1"])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    want = fnn.conv1d_cl(p["dec_post"]["conv"], torch.cat([y, skip], -1))
    got = y @ plan["w_post_x"] + skip @ plan["w_post_s"] + plan["b_post"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_frame_matches_pallas(case):
    jm, tm = _models(**CASES[case])
    jf, tf = _folded(jm, 2)
    x, h = _inputs(jm, 3, 2)
    kw = _step_kwargs(jm)
    mj, hj = jframe.fused_frame_step(jm.build_frame_plan(jf), jnp.asarray(x),
                                     jnp.asarray(h), interpret=True, **kw)
    mt, ht = tframe.fused_frame_step(tm.build_frame_plan(tf),
                                     torch.tensor(x), torch.tensor(h), **kw)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL)


def test_plain_frame_bf16_cast_points_match_pallas():
    jm, tm = _models(**CASES["sigmoid-resnet"])
    jf, tf = _folded(jm, 3)
    x, h = _inputs(jm, 4, 3)
    kw = _step_kwargs(jm)
    mj, hj = jframe.fused_frame_step(
        jm.build_frame_plan(jf, dtype=jnp.bfloat16),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
        interpret=True, **kw)
    mt, ht = tframe.fused_frame_step(
        tm.build_frame_plan(tf, dtype=torch.bfloat16),
        torch.tensor(x).bfloat16(), torch.tensor(h).bfloat16(), **kw)
    assert mt.dtype == ht.dtype == torch.bfloat16
    for got, want in ((mt, mj), (ht, hj)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(as_np(got), want,
                                   atol=2.0 ** -5 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_step_matches_streaming_step(case):
    """streaming_step_fused_frame against the port's and JAX's unfused
    streaming_step on the same folded variables, hop by hop, carries fed
    back on every side."""
    jm, tm = _models(**CASES[case])
    jf, tf = _folded(jm, 4)
    plan = tm.build_frame_plan(tf)
    b = 3
    c_frame = tm.init_streaming_carry(b, torch.float32, "cpu", fused=True)
    c_plain = tm.init_streaming_carry(b, torch.float32, "cpu")
    c_jax = jm.init_streaming_carry(b)
    step_j = jax.jit(jm.streaming_step)
    rng = np.random.default_rng(4)
    before = tframe.fused_frame_step.launches
    for _ in range(6):
        w = rng.uniform(-0.3, 0.3, (b, tm.hop_size)).astype(np.float32)
        c_frame, y_frame = tm.streaming_step_fused_frame(tf, plan, c_frame,
                                                         torch.tensor(w))
        c_plain, y_plain = tm.streaming_step(tf, c_plain, torch.tensor(w))
        c_jax, y_jax = step_j(jf, c_jax, jnp.asarray(w))
        np.testing.assert_allclose(y_frame.numpy(), y_plain.numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(y_frame.numpy(), np.asarray(y_jax),
                                   atol=ATOL)
    for i, h in enumerate(c_plain["h"]):
        np.testing.assert_allclose(c_frame["h"][i].numpy(), h.numpy(),
                                   atol=ATOL)
    assert tframe.fused_frame_step.launches == before  # the CPU launches none


def test_envelope_rejections():
    """tests/test_ops_pallas.py:350-362's cases, and what else the kernel
    does not take: post_act, another model's blocks."""
    jm, tm = _models()
    with pytest.raises(ValueError, match="fold"):
        tm.build_frame_plan(port_variables(jm.init(jax.random.PRNGKey(5))))
    for over, match in ((dict(activation="ReLU"), "SiLU"),
                        (dict(kernel_size=[4, 3]), "2\\*stride"),
                        (dict(rnnformer_kwargs=dict(
                            FRAME_KWARGS["rnnformer_kwargs"], post_act=True)),
                         "post_act")):
        jm, tm = _models(**over)
        _, tf = _folded(jm, 5)
        with pytest.raises(ValueError, match=match):
            tm.build_frame_plan(tf)
    dpt = TDptModel(channels=12, kernel_size=[8, 3], stride=4,
                    dpt_kwargs=dict(num_blocks=1, channels=8, freq=8,
                                    num_heads=2, lookbehind=3),
                    n_fft=128, hop_size=64, win_size=128, activation="SiLU")
    folded = dpt.fold(dpt.init(torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="RNNFormer"):
        dpt.build_frame_plan(folded)


def test_wrapper_cpu_path_and_checks():
    """A CPU tensor takes the plain version and launches nothing; bad
    operands raise before anything runs; FE T/B/S fit one thread block's
    shared memory and FE_M does not."""
    jm, tm = _models()
    _, tf = _folded(jm, 6)
    plan = tm.build_frame_plan(tf)
    x, h = (torch.tensor(a) for a in _inputs(tm, 2, 6))
    kw = _step_kwargs(tm)
    before = tframe.fused_frame_step.launches
    got = tframe.fused_frame_step(plan, x, h, **kw)
    kw_ref = dict(kw)
    del kw_ref["num_blocks"]
    want = tframe.fused_frame_reference(plan, x, h, **kw_ref)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tframe.fused_frame_step.launches == before
    with pytest.raises(ValueError, match="dtype|bfloat16"):
        tframe.fused_frame_step(plan, x.bfloat16(), h, **kw)
    with pytest.raises(ValueError, match="x must be"):
        tframe.fused_frame_step(plan, x[:, 1:], h, **kw)
    with pytest.raises(ValueError, match="shape"):
        tframe.fused_frame_step(plan, x, h[:, 1:], **kw)
    with pytest.raises(ValueError, match="mask"):
        tframe.fused_frame_step(plan, x, h, **dict(kw, mask="relu"))
    # (n_enc, F_enc, C, F', C', H): FE T, B, S, then M
    for shape in ((2, 64, 24, 16, 20, 4), (2, 64, 48, 24, 36, 4),
                  (3, 64, 64, 36, 48, 4)):
        assert tframe.smem_bytes(*shape, 4) <= tframe.MAX_SMEM_BYTES
    assert tframe.smem_bytes(3, 64, 96, 48, 72, 4, 4) > tframe.MAX_SMEM_BYTES
