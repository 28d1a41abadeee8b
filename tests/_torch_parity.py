"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; weights
move from the JAX package to the port with
`fastenhancer_tpu_torch.utils.bridge.from_jax`.
"""
import numpy as np
import jax
import torch

from fastenhancer_tpu_torch.utils import from_jax

# a tiny FastEnhancer: 2 blocks, C=8, F'=8, n_fft 128 (tests/test_ops_pallas.py)
TINY_KWARGS = dict(
    channels=12, kernel_size=[4, 3], stride=4,
    rnnformer_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2,
                          positional_embedding="train"),
    n_fft=128, hop_size=64, win_size=128, window="hann",
    weight_norm=True, pre_post_init="linear_fixed",
)


def to_np_tree(tree):
    """JAX tree -> the same tree with numpy leaves (None kept)."""
    return jax.tree.map(np.asarray, tree)


def port_variables(jax_variables):
    """JAX variables -> the port's variables on the CPU."""
    return from_jax(to_np_tree(jax_variables), device="cpu")


def flatten_paths(tree, prefix=()):
    """{path tuple: leaf} of a nested dict/list tree (None leaves kept)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_paths(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_paths(v, prefix + (str(i),)))
        return out
    return {prefix: tree}


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_trees_close(port_tree, jax_tree, atol):
    """Same paths, and every leaf within atol (None matches None)."""
    p, j = flatten_paths(port_tree), flatten_paths(to_np_tree(jax_tree))
    assert p.keys() == j.keys(), sorted(set(p) ^ set(j))
    for path in j:
        if j[path] is None:
            assert p[path] is None, path
            continue
        np.testing.assert_allclose(as_np(p[path]), as_np(j[path]), atol=atol,
                                   err_msg=str(path))


def perturb_bn_stats(jax_variables, seed):
    """Random BN running stats and affine params, so fold() does real work."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        if isinstance(stats, dict) and {"mean", "var"} <= stats.keys():
            n = np.asarray(stats["mean"]).shape
            stats = {"mean": rng.normal(0.0, 0.3, n).astype(np.float32),
                     "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
            if params is not None:
                params = {"weight": rng.uniform(0.5, 1.5, n).astype(np.float32),
                          "bias": rng.normal(0.0, 0.2, n).astype(np.float32)}
            return params, stats
        if isinstance(stats, dict):
            new_p, new_s = dict(params) if params else params, {}
            for k, v in stats.items():
                sub_p = params.get(k) if isinstance(params, dict) else None
                sp, ss = walk(sub_p, v)
                new_s[k] = ss
                if isinstance(new_p, dict) and k in new_p:
                    new_p[k] = sp
            return new_p, new_s
        if isinstance(stats, list):
            pairs = [walk(params[i] if params is not None else None, s)
                     for i, s in enumerate(stats)]
            new_p = list(params) if params is not None else None
            if new_p is not None:
                for i, (sp, _) in enumerate(pairs):
                    new_p[i] = sp
            return new_p, [s for _, s in pairs]
        return params, stats

    params, stats = walk(to_np_tree(jax_variables["params"]),
                         to_np_tree(jax_variables["stats"]))
    return {"params": params, "stats": stats}
