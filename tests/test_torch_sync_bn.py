"""The port's train-mode BatchNorm across ranks: two gloo ranks on the CPU
(spawned processes), each with its rows of one global batch, the rows
masked unevenly (rank 0 has 5 real rows of 6, rank 1 has 2), equal one
process on the concatenated batch: the output, the input gradient, the
parameter gradients summed over the ranks (as the train step sums them)
and the running statistics, to 1e-6 (of each quantity's largest magnitude
where that is above 1: the parameter gradients are sums over 35 rows x
bins, added in another order). They equal the JAX package's
`nn.layers.batch_norm` on that batch, to 1e-5 on the same terms.
Control: each rank alone, with its own statistics, misses the 1e-6 bound
a hundredfold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastenhancer_tpu.nn.layers import batch_norm as jbatch_norm
from fastenhancer_tpu_torch.nn.layers import batch_norm

import _torch_dist as dist_

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

WORLD, ROWS, F, C = 2, 6, 5, 4
TOL = 1e-6
JAX_TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((WORLD, ROWS, F, C)).astype(np.float32) * 2 + 1
    w = np.ones((WORLD, ROWS, 1, 1), np.float32)
    w[0, 5:] = 0.0   # rank 0: 5 real rows
    w[1, 2:] = 0.0   # rank 1: 2 real rows
    x *= w   # padded rows are zeros
    g = rng.standard_normal(x.shape).astype(np.float32)
    return {"x": x, "w": w, "g": g,
            "weight": rng.uniform(0.5, 1.5, C).astype(np.float32),
            "bias": rng.standard_normal(C).astype(np.float32),
            "mean": rng.standard_normal(C).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}


def _bn(inp, rows):
    """batch_norm in this process (no process group) on the given rows of
    the global batch."""
    x, w, g = (torch.from_numpy(np.concatenate(inp[k])[rows])
               for k in ("x", "w", "g"))
    x.requires_grad_(True)
    params = {k: torch.from_numpy(inp[k]).requires_grad_(True)
              for k in ("weight", "bias")}
    stats = {k: torch.from_numpy(inp[k]) for k in ("mean", "var")}
    y, new = batch_norm(params, stats, x, train=True, weight=w)
    (y * g).sum().backward()
    out = {"y": y, "x_grad": x.grad, "weight_grad": params["weight"].grad,
           "bias_grad": params["bias"].grad, **new}
    return {k: v.detach().numpy() for k, v in out.items()}


def _one_process(inp):
    """batch_norm on the concatenated batch, one process."""
    return _bn(inp, slice(None))


def _jax(inp):
    x = jnp.asarray(np.concatenate(inp["x"]))
    w = jnp.asarray(np.concatenate(inp["w"]))
    g = jnp.asarray(np.concatenate(inp["g"]))
    stats = {k: jnp.asarray(inp[k]) for k in ("mean", "var")}

    def f(x, params):
        y, new = jbatch_norm(params, stats, x, train=True, weight=w)
        return (y * g).sum(), (y, new)

    params = {k: jnp.asarray(inp[k]) for k in ("weight", "bias")}
    (_, (y, new)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, params)
    out = {"y": y, "x_grad": gx, "weight_grad": gp["weight"],
           "bias_grad": gp["bias"], **new}
    return {k: np.asarray(v) for k, v in out.items()}


def _merge(ranks):
    """The ranks' results as one process would hold them: rows
    concatenated, parameter gradients summed, statistics of rank 0."""
    merged = {k: np.concatenate([r[k] for r in ranks])
              for k in ("y", "x_grad")}
    merged.update({k: ranks[0][k] + ranks[1][k]
                   for k in ("weight_grad", "bias_grad")})
    merged.update({k: ranks[0][k] for k in ("mean", "var")})
    return merged


def _max_err(got, want):
    """Each quantity's largest error over max(1, its largest magnitude)."""
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(1.0, np.abs(want[k]).max())) for k in want}


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    inp = _inputs()
    out = str(tmp_path_factory.mktemp("sync_bn"))
    dist_.spawn(dist_.bn_worker, WORLD, out, inp)
    ranks = dist_.load_ranks(out, WORLD)
    return inp, ranks, _merge(ranks)


def test_two_ranks_equal_one_process_on_the_global_batch(synced):
    inp, ranks, merged = synced
    for k in ("mean", "var"):
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k])
    err = _max_err(merged, _one_process(inp))
    assert max(err.values()) <= TOL, err


def test_two_ranks_equal_jax_on_the_global_batch(synced):
    inp, _, merged = synced
    err = _max_err(merged, _jax(inp))
    assert max(err.values()) <= JAX_TOL, err


def test_local_statistics_miss():
    """Each rank's rows alone, with their own statistics (the running
    statistics averaged over the ranks, as if merged after the fact)."""
    inp = _inputs()
    ranks = [_bn(inp, slice(r * ROWS, (r + 1) * ROWS)) for r in range(WORLD)]
    merged = _merge(ranks)
    merged.update({k: (ranks[0][k] + ranks[1][k]) / 2
                   for k in ("mean", "var")})
    err = _max_err(merged, _one_process(inp))
    assert min(err[k] for k in ("y", "x_grad", "mean", "var")) > 100 * TOL, \
        err
