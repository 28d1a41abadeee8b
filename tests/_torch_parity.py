"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; weights
move from the JAX package to the port with
`fastenhancer_tpu_torch.utils.bridge.from_jax`.
"""
import contextlib
import os
import signal
import sys
import threading

import numpy as np
import jax
import pytest
import torch
# once, while the test files are collected, before any test can leave a
# stub `triton` in sys.modules (see real_triton_only): a later test in this
# process that reaches torch._dynamo through torch.optim then finds it
# imported, whichever files ran on its worker before it
import torch._dynamo  # noqa: F401,E402

from fastenhancer_tpu_torch.serving import StreamingEngine
from fastenhancer_tpu_torch.utils import from_jax

# a tiny FastEnhancer: 2 blocks, C=8, F'=8, n_fft 128 (tests/test_ops_pallas.py)
TINY_KWARGS = dict(
    channels=12, kernel_size=[4, 3], stride=4,
    rnnformer_kwargs=dict(num_blocks=2, channels=8, freq=8, num_heads=2,
                          positional_embedding="train"),
    n_fft=128, hop_size=64, win_size=128, window="hann",
    weight_norm=True, pre_post_init="linear_fixed",
)


@pytest.fixture(scope="module")
def real_triton_only():
    """Take a stub `triton` (a module without a file, which
    tests/test_shard_pipeline.py leaves in sys.modules) out while the
    module's tests run, and put it back after them. torch.optim's
    Optimizer imports torch._dynamo, which trips on the stub; the first
    import of it is made here without the stub, with torch's cached
    "is triton installed" answer cleared."""
    from torch.utils import _triton

    stubs = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] == "triton"
             and getattr(sys.modules[k], "__file__", None) is None}
    _triton.has_triton_package.cache_clear()
    import torch._dynamo  # noqa: F401
    yield
    sys.modules.update(stubs)
    _triton.has_triton_package.cache_clear()


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


def perturb_norms(params, seed):
    """The ln ablation's params with every GroupNorm (gn, gn1, gn2) and
    LayerNorm (ln) affine pair set to weight ~ 1 + 0.2 N(0, 1) and
    bias ~ 0.1 N(0, 1), numpy leaves, so that the reference LayerNorm's
    `diff + inv * weight * bias` quirk matters."""
    rng = np.random.default_rng(seed)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            if key in ("gn", "gn1", "gn2", "ln") \
                    and set(tree) == {"weight", "bias"}:
                n = np.asarray(tree["weight"]).shape
                return {"weight": (1.0 + 0.2 * rng.standard_normal(n)
                                   ).astype(np.float32),
                        "bias": (0.1 * rng.standard_normal(n)
                                 ).astype(np.float32)}
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


def check_engine_fused_matches_unfused(model, folded, atol):
    """Two CPU engines of capacity 2, fused and unfused, on one schedule: a
    and b together for 2 ticks, b leaves, c takes b's slot for 4 ticks (its
    last hop silence). Every stream's raw output equals its isolated
    `stream()` run through the same path, and the two engines agree."""
    hop = model.hop_size
    rng = np.random.default_rng(5)
    wav = {k: rng.uniform(-0.3, 0.3, n * hop).astype(np.float32)
           for k, n in (("a", 6), ("b", 2), ("c", 3))}
    results = []
    for fused in (False, True):
        engine = StreamingEngine(model, folded, capacity=2, fused=fused,
                                 device="cpu")
        outs = {k: [] for k in wav}
        ha, hb = engine.open_stream(), engine.open_stream()
        for i in range(2):
            o = engine.tick({ha: wav["a"][i * hop:(i + 1) * hop],
                             hb: wav["b"][i * hop:(i + 1) * hop]})
            outs["a"].append(o[ha])
            outs["b"].append(o[hb])
        engine.close_stream(hb)
        hc = engine.open_stream()
        assert engine._slot_of[hc] == 1  # really reusing the freed slot
        for i in range(2, 6):
            c = wav["c"][(i - 2) * hop:(i - 1) * hop]
            o = engine.tick({ha: wav["a"][i * hop:(i + 1) * hop],
                             hc: c if len(c) else np.zeros(hop, np.float32)})
            outs["a"].append(o[ha])
            outs["c"].append(o[hc])
        plan = model.build_stack_plan(folded) if fused else None
        got = {k: np.concatenate(v) for k, v in outs.items()}
        for k, y in got.items():
            x = np.zeros(len(y), np.float32)
            x[:min(len(y), len(wav[k]))] = wav[k][:len(y)]
            want = model.stream(folded, torch.tensor(x[None]),
                                fused_plan=plan)[0].numpy()
            np.testing.assert_allclose(y, want, atol=atol, err_msg=k)
        results.append(got)
    for k in wav:
        np.testing.assert_allclose(results[1][k], results[0][k], atol=atol)


# -- synthetic corpora: shard dirs and paired wav dirs ---------------------------

SR = 16_000


def wav_bytes(x, sr=SR):
    """A mono 16-bit PCM WAV file's bytes."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.clip(np.asarray(x) * 32768, -32768, 32767)
                      .astype("<i2").tobytes())
    return buf.getvalue()


def write_shard_dir(root, name, seed, n_shards=2, cuts=4, dur=(0.6, 2.0),
                    custom=None, silent_first=False):
    """`n_shards` shards of `cuts` noise-like cuts each (cuts.NNNNNN.jsonl.gz
    + recording.NNNNNN.tar of 16 kHz WAVs), as ShardSource reads them;
    silent_first zeroes the first cut of each shard. Returns the dir."""
    import gzip
    import io
    import json
    import os
    import tarfile

    d = os.path.join(str(root), name)
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for s in range(n_shards):
        metas = []
        with tarfile.open(os.path.join(d, f"recording.{s:06d}.tar"),
                          "w") as tar:
            for c in range(cuts):
                cid = f"{name}-{s}-{c}"
                n = int(rng.uniform(*dur) * SR)
                x = rng.standard_normal(n) * 0.1
                x[n // 3: n // 2] = 0.0
                if silent_first and c == 0:
                    x[:] = 0.0
                data = wav_bytes(x)
                info = tarfile.TarInfo(f"{cid}.wav")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
                meta = {"id": cid, "duration": n / SR}
                if custom:
                    meta["custom"] = custom
                metas.append(meta)
        with gzip.open(os.path.join(d, f"cuts.{s:06d}.jsonl.gz"), "wt") as f:
            for m in metas:
                f.write(json.dumps(m) + "\n")
    return d


def write_wav_pairs(root, seed, n=6, dur=(0.5, 1.5)):
    """{root}/clean and {root}/noisy with n paired 16 kHz WAVs of random
    lengths; returns (clean_dir, noisy_dir)."""
    import os

    dirs = [os.path.join(str(root), k) for k in ("clean", "noisy")]
    for d in dirs:
        os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        t = int(rng.uniform(*dur) * SR)
        clean = rng.standard_normal(t) * 0.1
        noisy = clean + rng.standard_normal(t) * 0.05
        for d, x in zip(dirs, (clean, noisy)):
            with open(os.path.join(d, f"{i:03d}.wav"), "wb") as f:
                f.write(wav_bytes(x))
    return tuple(dirs)


def check_train_forward_runs(model, variables, wav, moves_stats=True):
    """forward(train=True) runs: finite outputs and new statistics at the
    paths of the old ones, some of them moved where the model keeps any
    (tests/test_torch_train_*.py hold it against JAX)."""
    w, s, new_stats = model.forward(variables, wav, train=True)
    assert torch.isfinite(w).all() and torch.isfinite(s).all()
    new, old = flatten_paths(new_stats), flatten_paths(variables["stats"])
    assert new.keys() == old.keys()
    assert all(torch.isfinite(v).all() for v in new.values())
    assert any(not torch.equal(new[k], old[k]) for k in old) == moves_stats


@pytest.fixture(scope="module")
def torch_one_thread():
    """One intra-op thread while the module's tests run, restored after:
    the driver runs six xdist workers on eight cores, and the tiny ops of
    the training tests spend an eight-thread run waiting on the threads of
    the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_thread_env(**extra):
    """os.environ for a test's child process, with one intra-op thread for
    torch's and the BLAS libraries' pools (as torch_one_thread gives the
    test process), and `extra` on top."""
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                **extra)


@contextlib.contextmanager
def deadline(seconds, what):
    """TimeoutError inside the block once it has run `seconds`: a test that
    waits on a pool of child processes fails when they hang, instead of
    holding its xdist worker until the suite's clock runs out. SIGALRM, so
    in the main thread only (elsewhere the block runs unbounded)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"{what}: not done in {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
