"""The block-stack op (fastenhancer_tpu_torch/ops/rnnformer_stack.py).

The plan and the plain version, in the folded default form and the ln
ablation's LN form, against the JAX package's Pallas kernel (interpret
mode) and its `_block_apply` loop. The CUDA kernel itself is tested on the
card by tests/test_torch_cuda_kernels.py.

Tolerances: float32 1e-5 absolute (dot products of <= 48 terms on values of
order 1-10); bfloat16 vs the Pallas kernel: 2^-5 of the largest magnitude,
a few bf16 ulps, since the two sum in different orders and a sum that lands
on a rounding boundary can round either way and carry through later blocks.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.fastenhancer.default import Model as JModel
from fastenhancer_tpu.models.fastenhancer.ln import Model as JLnModel
from fastenhancer_tpu.ops import rnnformer_stack as jstack
from fastenhancer_tpu_torch.models.fastenhancer.default import Model as TModel
from fastenhancer_tpu_torch.models.fastenhancer.ln import Model as TLnModel
from fastenhancer_tpu_torch.ops import rnnformer_stack as tstack

from _torch_parity import (TINY_KWARGS, as_np, perturb_norms, port_variables,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5


def _tiny(freq=8):
    kw = dict(TINY_KWARGS)
    kw["rnnformer_kwargs"] = dict(kw["rnnformer_kwargs"], freq=freq)
    return JModel(**kw), TModel(**kw)


def _folded(jm, seed):
    jf = jm.fold(jm.init(jax.random.PRNGKey(seed)))
    return jf, port_variables(jf)


def _inputs(jm, b, seed):
    rng = np.random.default_rng(seed)
    f, c = jm.block_freq, jm.block_channels
    x = rng.standard_normal((b, f, c)).astype(np.float32)
    h = (rng.standard_normal((jm.num_blocks, b * f, c)) * 0.5).astype(
        np.float32)
    return x, h


def test_plan_matches_jax_plan():
    """Per-gate GRU weights, summed r/z biases with b_in/b_hn apart, the
    per-head [q|k|v] row gather, and pe only in block 0."""
    jm, tm = _tiny()
    jfold, tfold = _folded(jm, 0)
    jp = jstack.plan_stack(jfold["params"]["rf_blocks"], jm.block_freq,
                           jm.rf.num_heads)
    tp_ = tm.build_stack_plan(tfold)
    for g, gate in enumerate("rzn"):
        np.testing.assert_array_equal(as_np(tp_["w_x"][:, g]),
                                      np.asarray(jp[f"w_x{gate}"]))
        np.testing.assert_array_equal(as_np(tp_["w_h"][:, g]),
                                      np.asarray(jp[f"w_h{gate}"]))
    for j, name in enumerate(("b_r", "b_z", "b_xn", "b_hn")):
        np.testing.assert_array_equal(as_np(tp_["b_gru"][:, j]),
                                      np.asarray(jp[name])[:, 0])
    for o, name in enumerate("qkv"):
        np.testing.assert_array_equal(as_np(tp_["w_qkv"][:, o]),
                                      np.asarray(jp[f"w_{name}"]))
        np.testing.assert_array_equal(as_np(tp_["b_qkv"][:, o]),
                                      np.asarray(jp[f"b_{name}"])[:, 0])
    for name in ("w_fc", "w_afc"):
        np.testing.assert_array_equal(as_np(tp_[name]), np.asarray(jp[name]))
    np.testing.assert_array_equal(as_np(tp_["pe"]), np.asarray(jp["pe"]))
    assert as_np(tp_["pe"][0]).any() and not as_np(tp_["pe"][1]).any()
    with pytest.raises(ValueError, match="fold"):
        tm.build_stack_plan(port_variables(jm.init(jax.random.PRNGKey(0))))


@pytest.mark.parametrize("freq", [8, 6])
def test_plain_stack_matches_pallas_and_block_apply(freq):
    """freq=6 is not a multiple of 8: the Pallas kernel pads it to 16 and
    masks the padded keys; the port takes it as it is."""
    jm, tm = _tiny(freq)
    jfold, tfold = _folded(jm, 1)
    x, h = _inputs(jm, 3, 1)
    jp = jstack.plan_stack(jfold["params"]["rf_blocks"], freq, jm.rf.num_heads)
    xo_j, ho_j = jstack.rnnformer_stack_step(jp, jnp.asarray(x),
                                             jnp.asarray(h), jm.rf.num_heads,
                                             interpret=True)
    plan = tm.build_stack_plan(tfold)
    xo_t, ho_t = tstack.rnnformer_stack_reference(
        plan, torch.tensor(x), torch.tensor(h), tm.rf.num_heads)
    np.testing.assert_allclose(xo_t.numpy(), np.asarray(xo_j), atol=ATOL)
    np.testing.assert_allclose(ho_t.numpy(), np.asarray(ho_j), atol=ATOL)

    # the XLA form: JAX's _block_apply over the folded blocks
    x_ref = jnp.asarray(x)[None]
    for i, (bp, bs) in enumerate(zip(jfold["params"]["rf_blocks"],
                                     jfold["stats"]["rf_blocks"])):
        x_ref, h_t, _ = jm._block_apply(bp, bs, x_ref, jnp.asarray(h[i]),
                                        train=False)
        np.testing.assert_allclose(ho_t[i].numpy(), np.asarray(h_t),
                                   atol=ATOL)
    np.testing.assert_allclose(xo_t.numpy(), np.asarray(x_ref[0]), atol=ATOL)


def test_plain_stack_bf16_cast_points_match_pallas():
    """bf16 activations and plan: the port rounds where the Pallas kernel
    rounds (q/k/v, probabilities, attention output, fc outputs, h_new)."""
    jm, tm = _tiny()
    jfold, tfold = _folded(jm, 2)
    x, h = _inputs(jm, 4, 2)
    jp = jstack.plan_stack(jfold["params"]["rf_blocks"], jm.block_freq,
                           jm.rf.num_heads, dtype=jnp.bfloat16)
    xo_j, ho_j = jstack.rnnformer_stack_step(
        jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
        jm.rf.num_heads, interpret=True)
    plan = tm.build_stack_plan(tfold, dtype=torch.bfloat16)
    xo_t, ho_t = tstack.rnnformer_stack_reference(
        plan, torch.tensor(x).bfloat16(), torch.tensor(h).bfloat16(),
        tm.rf.num_heads)
    assert xo_t.dtype == ho_t.dtype == torch.bfloat16
    for got, want in ((xo_t, xo_j), (ho_t, ho_j)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(as_np(got), want,
                                   atol=2.0 ** -5 * np.abs(want).max())


def test_softmax_underflow_input_matches_xla_path():
    """tests/test_ops_pallas.py's underflow input: head 0's logits sit far
    above head 1's. The Pallas kernel (global row max) returns 0 for the
    underflowed head; the port uses a per-head max, like the XLA path, and
    matches that path (relative 1e-5: the values reach ~1e3)."""
    jm, tm = _tiny()
    jfold = jm.fold(jm.init(jax.random.PRNGKey(7)))
    blocks = jfold["params"]["rf_blocks"]
    c = jm.block_channels
    w = np.asarray(blocks[0]["attn"]["qkv"]["weight"]).copy()
    w[:c // 2] *= 4000.0     # q rows of head 0 (per-head [q|k|v] layout)
    blocks[0]["attn"]["qkv"]["weight"] = jnp.asarray(w)
    tfold = port_variables(jfold)
    rng = np.random.default_rng(7)
    b = 2
    x = rng.uniform(1.0, 2.0, (b, jm.block_freq, c)).astype(np.float32)
    h = np.zeros((len(blocks), b * jm.block_freq, c), np.float32)
    xo_t, ho_t = tstack.rnnformer_stack_step(
        tm.build_stack_plan(tfold), torch.tensor(x), torch.tensor(h),
        tm.rf.num_heads)
    assert torch.isfinite(xo_t).all() and torch.isfinite(ho_t).all()
    x_ref = jnp.asarray(x)[None]
    for bp, bs, hi in zip(blocks, jfold["stats"]["rf_blocks"], h):
        x_ref, _, _ = jm._block_apply(bp, bs, x_ref, jnp.asarray(hi),
                                      train=False)
    want = np.asarray(x_ref[0])
    np.testing.assert_allclose(xo_t.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_wrapper_cpu_path_and_checks():
    """A CPU tensor takes the plain version and launches nothing; bad
    operands raise before anything runs."""
    jm, tm = _tiny()
    _, tfold = _folded(jm, 3)
    plan = tm.build_stack_plan(tfold)
    x, h = (torch.tensor(a) for a in _inputs(jm, 2, 3))
    before = tstack.rnnformer_stack_step.launches
    got = tstack.rnnformer_stack_step(plan, x, h, tm.rf.num_heads)
    want = tstack.rnnformer_stack_reference(plan, x, h, tm.rf.num_heads)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tstack.rnnformer_stack_step.launches == before
    with pytest.raises(ValueError, match="dtype|bfloat16"):
        tstack.rnnformer_stack_step(plan, x, h.bfloat16(), tm.rf.num_heads)
    with pytest.raises(ValueError, match="contiguous"):
        tstack.rnnformer_stack_step(plan, x.transpose(1, 2).contiguous()
                                    .transpose(1, 2), h, tm.rf.num_heads)
    with pytest.raises(ValueError, match="shape"):
        tstack.rnnformer_stack_step(plan, x, h[:, 1:], tm.rf.num_heads)
    with pytest.raises(ValueError, match="H="):
        tstack.rnnformer_stack_step(plan, x, h, 3)


def test_shared_memory_fits_fastenhancer_shapes():
    """FE_T/B/S/M/L block shapes (F, C, H) fit one thread block's shared
    memory; a much wider one does not."""
    for f, c in ((16, 20), (24, 36), (36, 48), (48, 64), (64, 72)):
        assert tstack.smem_bytes(f, c, 4) <= tstack.MAX_SMEM_BYTES
    assert tstack.smem_bytes(256, 64, 4) > tstack.MAX_SMEM_BYTES


# -- the LN form (the ln ablation's plan, plan_stack(..., ln_eps=...)) ------

def _ln_case(freq, seed, b):
    """The tiny ln model at block frequency `freq`, folded, with
    non-trivial LayerNorm affine params; JAX's and the port's folded
    variables and a random frame and carry."""
    kw = dict(TINY_KWARGS)
    kw["rnnformer_kwargs"] = dict(kw["rnnformer_kwargs"], freq=freq)
    jm, tm = JLnModel(**kw), TLnModel(**kw)
    jv = jm.init(jax.random.PRNGKey(seed))
    jv = {"params": perturb_norms(jv["params"], seed), "stats": jv["stats"]}
    jf = jm.fold(jax.tree.map(jnp.asarray, jv))
    x, h = _inputs(jm, b, seed)
    return jm, tm, jf, port_variables(jf), x, h


def test_ln_plan_matches_jax_plan():
    """wb_fc and wb_afc are JAX's weight * bias (taken in float32, then
    cast), eps a float, and the rest the default plan; no frequency mask."""
    jm, tm, jf, tf, _, _ = _ln_case(10, 0, 1)
    for dtype, jdtype in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        jp = jstack.plan_stack(jf["params"]["rf_blocks"], jm.block_freq,
                               jm.rf.num_heads, dtype=jdtype, ln_eps=jm.rf.eps)
        plan = tm.build_stack_plan(tf, dtype=dtype)
        assert set(plan) == set(tstack.PLAN_KEYS + tstack.LN_KEYS) | {
            "ln_eps"}
        assert isinstance(plan["ln_eps"], float)
        assert np.float32(plan["ln_eps"]) == np.asarray(jp["ln_eps"])[0, 0]
        for key in tstack.LN_KEYS:
            assert plan[key].shape == (jm.num_blocks, jm.block_channels)
            np.testing.assert_array_equal(as_np(plan[key]),
                                          np.asarray(jp[key], np.float32)[:, 0])
        np.testing.assert_array_equal(as_np(plan["w_fc"]),
                                      np.asarray(jp["w_fc"], np.float32))


@pytest.mark.parametrize("freq", [8, 10])
def test_ln_plain_stack_matches_pallas(freq):
    """float32, 1e-5: the LN form's plain version against the Pallas
    kernel's stack_math(ln=True) in interpret mode. At F'=10 the Pallas
    kernel pads the rows to 16 and keeps them out of the LayerNorm
    statistics (fmask); the port has no padding."""
    jm, tm, jf, tf, x, h = _ln_case(freq, 1, 3)
    jp = jstack.plan_stack(jf["params"]["rf_blocks"], freq, jm.rf.num_heads,
                           ln_eps=jm.rf.eps)
    xo_j, ho_j = jstack.rnnformer_stack_step(jp, jnp.asarray(x),
                                             jnp.asarray(h), jm.rf.num_heads,
                                             interpret=True)
    plan = tm.build_stack_plan(tf)
    xo_t, ho_t = tstack.rnnformer_stack_step(plan, torch.tensor(x),
                                             torch.tensor(h), tm.rf.num_heads)
    np.testing.assert_allclose(xo_t.numpy(), np.asarray(xo_j), atol=ATOL)
    np.testing.assert_allclose(ho_t.numpy(), np.asarray(ho_j), atol=ATOL)


def test_ln_plain_stack_bf16_cast_points_match_pallas():
    """bf16 activations and plan: the fc output, the LayerNorm's output and
    the residual sum are rounded where the Pallas kernel rounds them.
    Tolerance 2^-5 of the largest magnitude, as for the default form."""
    jm, tm, jf, tf, x, h = _ln_case(8, 2, 4)
    jp = jstack.plan_stack(jf["params"]["rf_blocks"], jm.block_freq,
                           jm.rf.num_heads, dtype=jnp.bfloat16,
                           ln_eps=jm.rf.eps)
    xo_j, ho_j = jstack.rnnformer_stack_step(
        jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
        jm.rf.num_heads, interpret=True)
    plan = tm.build_stack_plan(tf, dtype=torch.bfloat16)
    xo_t, ho_t = tstack.rnnformer_stack_reference(
        plan, torch.tensor(x).bfloat16(), torch.tensor(h).bfloat16(),
        tm.rf.num_heads)
    assert xo_t.dtype == ho_t.dtype == torch.bfloat16
    for got, want in ((xo_t, xo_j), (ho_t, ho_j)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(as_np(got), want,
                                   atol=2.0 ** -5 * np.abs(want).max())


def test_ln_wrapper_cpu_path_and_checks():
    """A CPU tensor takes the plain version and counts no launch of either
    form; an LN plan without its float eps, or with a wb of the wrong
    shape, raises."""
    _, tm, _, tf, x, h = _ln_case(8, 3, 2)
    plan = tm.build_stack_plan(tf)
    x, h = torch.tensor(x), torch.tensor(h)
    step = tstack.rnnformer_stack_step
    before = (step.launches, step.ln_launches)
    got = step(plan, x, h, tm.rf.num_heads)
    want = tstack.rnnformer_stack_reference(plan, x, h, tm.rf.num_heads)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (step.launches, step.ln_launches) == before
    with pytest.raises(ValueError, match="ln_eps"):
        step({k: v for k, v in plan.items() if k != "ln_eps"}, x, h,
             tm.rf.num_heads)
    with pytest.raises(ValueError, match="ln_eps"):
        step(dict(plan, ln_eps=torch.tensor(1e-5)), x, h, tm.rf.num_heads)
    with pytest.raises(ValueError, match="wb_afc"):
        step(dict(plan, wb_afc=plan["wb_afc"][:, 1:].contiguous()), x, h,
             tm.rf.num_heads)
