"""PyTorch port of nn/{layers,gru,attention}.py against the JAX package.

Same numpy weights and inputs through both. Tolerance 1e-5 absolute:
float32 rounding of short (<= 36-term) dot products on unit-scale values.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu import nn as jnn
from fastenhancer_tpu_torch import nn as tnn

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.tensor, tree)


def test_linear_matches_jax():
    rng = np.random.default_rng(0)
    p = {"weight": _rand(rng, 7, 5), "bias": _rand(rng, 7)}
    x = _rand(rng, 3, 4, 5)
    y_j = np.asarray(jnn.linear(_j(p), jnp.asarray(x)))
    y_t = tnn.linear(_t(p), torch.tensor(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=ATOL)


@pytest.mark.parametrize("stride,padding,bias", [(1, 1, True), (2, 0, False),
                                                 (1, 0, False)])
def test_conv1d_cl_matches_jax(stride, padding, bias):
    rng = np.random.default_rng(1)
    p = {"weight": _rand(rng, 6, 4, 3, scale=0.3)}
    if bias:
        p["bias"] = _rand(rng, 6)
    x = _rand(rng, 2, 11, 4)
    y_j = np.asarray(jnn.conv1d_cl(_j(p), jnp.asarray(x), stride=stride,
                                   padding=padding))
    y_t = tnn.conv1d_cl(_t(p), torch.tensor(x), stride=stride,
                        padding=padding).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=ATOL)


@pytest.mark.parametrize("stride,padding", [(4, 2), (2, 0), (1, 1)])
def test_conv_transpose1d_cl_matches_jax(stride, padding):
    rng = np.random.default_rng(2)
    p = {"weight": _rand(rng, 5, 2, 8, scale=0.3), "bias": _rand(rng, 2)}
    x = _rand(rng, 3, 9, 5)
    y_j = np.asarray(jnn.conv_transpose1d_cl(
        _j(p), jnp.asarray(x), stride=stride, padding=padding))
    y_t = tnn.conv_transpose1d_cl(_t(p), torch.tensor(x), stride=stride,
                                  padding=padding).numpy()
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, atol=ATOL)


@pytest.mark.parametrize("affine", [True, False])
def test_batch_norm_eval_matches_jax(affine):
    rng = np.random.default_rng(3)
    c = 6
    stats = {"mean": _rand(rng, c), "var": rng.uniform(0.5, 2, c).astype(
        np.float32)}
    params = ({"weight": _rand(rng, c), "bias": _rand(rng, c)} if affine
              else None)
    x = _rand(rng, 4, 5, c)
    y_j, _ = jnn.batch_norm(None if params is None else _j(params),
                            _j(stats), jnp.asarray(x), train=False, eps=1e-5)
    y_t, s_t = tnn.batch_norm(None if params is None else _t(params),
                              _t(stats), torch.tensor(x), train=False,
                              eps=1e-5)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnn.batch_norm(None, _t(stats), torch.tensor(x), train=True)


def test_weight_norm_matches_jax():
    rng = np.random.default_rng(4)
    w = _rand(rng, 12, 4, 3)
    wn_j = jnn.to_wn(jnp.asarray(w))
    wn_t = tnn.to_wn(torch.tensor(w))
    np.testing.assert_allclose(wn_t["g"].numpy(), np.asarray(wn_j["g"]),
                               atol=ATOL)
    wn = {"g": _rand(rng, 12, 1, 1), "v": w}
    np.testing.assert_allclose(tnn.wn_weight(_t(wn)).numpy(),
                               np.asarray(jnn.wn_weight(_j(wn))), atol=ATOL)
    np.testing.assert_allclose(
        tnn.maybe_wn_weight({"weight": _t(wn)}).numpy(),
        np.asarray(jnn.maybe_wn_weight({"weight": _j(wn)})), atol=ATOL)


@pytest.mark.parametrize("name", ["ReLU", "SiLU", "GELU", "Tanh", "Sigmoid",
                                  "LeakyReLU", "ELU", "Identity"])
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 41, dtype=np.float32)
    y_j = np.asarray(jnn.get_activation(name)(jnp.asarray(x)))
    y_t = tnn.get_activation(name)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-6)


def _gru_params(rng, i, h, wn):
    p = {"weight_ih": _rand(rng, 3 * h, i, scale=0.3),
         "weight_hh": _rand(rng, 3 * h, h, scale=0.3),
         "bias_ih": _rand(rng, 3 * h, scale=0.3),
         "bias_hh": _rand(rng, 3 * h, scale=0.3)}
    if wn:
        p["weight_ih"] = {"g": _rand(rng, 3 * h, 1), "v": p["weight_ih"]}
    return p


@pytest.mark.parametrize("wn", [False, True])
def test_gru_and_gru_step_match_jax(wn):
    """Full sequence, and one streaming step, in torch gate order r, z, n
    (weight-norm {g, v} input weights in the second case)."""
    rng = np.random.default_rng(5)
    p = _gru_params(rng, 6, 8, wn)
    x = _rand(rng, 9, 4, 6)
    h0 = _rand(rng, 4, 8, scale=0.5)
    y_j, ht_j = jnn.gru(_j(p), jnp.asarray(x), jnp.asarray(h0))
    y_t, ht_t = tnn.gru(_t(p), torch.tensor(x), torch.tensor(h0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(ht_t.numpy(), np.asarray(ht_j), atol=ATOL)
    s_j = jnn.gru_step(_j(p), jnp.asarray(x[0]), jnp.asarray(h0))
    s_t = tnn.gru_step(_t(p), torch.tensor(x[0]), torch.tensor(h0))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)
    y0_t, _ = tnn.gru(_t(p), torch.tensor(x))  # zero initial state
    y0_j, _ = jnn.gru(_j(p), jnp.asarray(x))
    np.testing.assert_allclose(y0_t.numpy(), np.asarray(y0_j), atol=ATOL)


@pytest.mark.parametrize("n,bias", [(5, False), (70, True)])
def test_attention_matches_jax(n, bias):
    """n=70 takes the JAX package's masked-lane branch (n >= 64), which the
    port computes in the head-dim form."""
    rng = np.random.default_rng(6)
    c, f, heads = 12, 7, 3
    p = {"qkv": {"weight": {"g": _rand(rng, 3 * c, 1),
                            "v": _rand(rng, 3 * c, c, scale=0.3)}}}
    if bias:
        p["qkv"]["bias"] = _rand(rng, 3 * c)
    x = _rand(rng, n, f, c)
    y_j = np.asarray(jnn.attention(_j(p), jnp.asarray(x), heads))
    y_t = tnn.attention(_t(p), torch.tensor(x), heads).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=ATOL)


def test_inits_have_torch_default_bounds():
    g = torch.Generator().manual_seed(0)
    lin = tnn.torch_linear_init(g, 5, 16, True, "cpu")
    assert lin["weight"].shape == (5, 16) and lin["bias"].shape == (5,)
    assert lin["weight"].abs().max() <= 0.25
    conv = tnn.torch_conv1d_init(g, 6, 4, 3, False, "cpu")
    assert conv["weight"].abs().max() <= 1 / 12 ** 0.5 and "bias" not in conv
    convt = tnn.torch_convtranspose1d_init(g, 6, 2, 8, True, "cpu")
    assert convt["weight"].shape == (6, 2, 8)
    assert convt["weight"].abs().max() <= 0.25
    gru = tnn.init_gru(g, 4, 9, "cpu")
    assert gru["weight_hh"].shape == (27, 9)
    assert max(t.abs().max() for t in gru.values()) <= 1 / 3
    # same seed, same weights
    a = tnn.torch_linear_init(torch.Generator().manual_seed(3), 4, 4, False,
                              "cpu")["weight"]
    b = tnn.torch_linear_init(torch.Generator().manual_seed(3), 4, 4, False,
                              "cpu")["weight"]
    assert torch.equal(a, b)
