"""Data-parallel training of the port over two gloo ranks on the CPU
(spawned processes): W ranks at batch B take the step of one process at
W * B, as the JAX package's multi-process training does.

(1) One float32 train step of FE (fastenhancer.default) and of FSPEN (the
baseline with train-mode BN) with its recipe's train section, each rank
holding 3 rows of a 6-row global batch whose last row is padding (rank 0:
3 real rows, rank 1: 2), against the JAX package's train step on the
global batch with its row_mask: losses, grad norm, every gradient, param
and BN statistic at tests/_torch_train_parity.py's tolerances; the two
ranks hold the same metrics, params and statistics bit for bit.
(2) The training CLI at 2 ranks x batch 2 against the CLI in one process
at batch 4 on the same length-sorted paired wavs, 2 epochs, float32 (the
two de-chaos settings of tests/test_multihost.py: AdamP's projection off,
eps 1e-4): the final checkpoint's params and statistics to rtol 5e-4 and
atol 1e-6 (JAX's bound there) and the printed valid losses to 1e-3; only
rank 0 writes the run's files and prints the epochs.
Every spawn has a deadline (tests/_torch_dist.py), so a hang fails.
"""
import os

import numpy as np
import pytest
import torch

from fastenhancer_tpu_torch.data.audio_io import write_wav
from fastenhancer_tpu_torch.train import load_checkpoint
from fastenhancer_tpu_torch.train.__main__ import main
from fastenhancer_tpu_torch.utils import tree_map, tree_paths

from _torch_parity import (SR, TINY_KWARGS, flatten_paths,  # noqa: F401
                           real_triton_only, to_np_tree, torch_one_thread)
import _torch_dist as dist_
import _torch_train_parity as tp

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

WORLD = 2
# the share of param elements assert_steps_match holds to its wide bound:
# measured 0.005 (default) and 0.627 (FSPEN: AdamP widens a whole leaf
# when one element's gradient is within float32 noise of zero; the ranks'
# two partial sums put 13 of FSPEN's leaves there, one process 7, every
# gradient still within GRAD_REL of JAX's)
WIDE_SHARE = {"default": 0.01, "fspen": 0.7}
CASES = {
    "default": ("fastenhancer.default", TINY_KWARGS, "fastenhancer/t.yaml"),
    "fspen": ("fspen", dict(channels=[4, 8, 16], stft_method="matmul",
                            dpe_kwargs=dict(num_blocks=1, channels=8,
                                            groups=2)),
              "others/fspen.yaml"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_take_jax_step_on_the_global_batch(name, tmp_path):
    model, kwargs, config = CASES[name]
    case = tp.build_case(model, kwargs, config)
    hop = kwargs.get("hop_size", 256)
    batch = tp.make_batch(1, WORLD * 3, hop * 12)
    join = dist_.start(dist_.step_worker, WORLD, str(tmp_path), {
        "model": model, "kwargs": kwargs, "hp": case["hp"],
        "variables": to_np_tree(case["tv"]),
        "batch": {k: v.reshape((WORLD, 3) + v.shape[1:])
                  for k, v in batch.items()}})
    (jstep,) = tp.run_jax_steps(case["jm"], case["jv"], case["hp"], batch,
                                steps=1)
    join()
    ranks = dist_.load_ranks(str(tmp_path), WORLD)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for a, b in zip(tree_paths(ranks[0]["variables"]),
                    tree_paths(ranks[1]["variables"])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=str(a[0]))
    r = ranks[0]
    grads = {p: torch.from_numpy(g) for p, g in r["grads"].items()}
    tp.assert_grads_close(grads, jstep[2])
    wide, total = tp.assert_steps_match(
        [(r["lrs"], r["metrics"], grads,
          tree_map(torch.from_numpy, r["variables"]))], [jstep],
        projected=case["hp"]["optimizer"] == "AdamP")
    assert wide <= WIDE_SHARE[name] * total, (wide, total)


def _corpus(root):
    """8 paired wavs of 1-1.9 s, as tests/test_multihost.py writes them."""
    rng = np.random.default_rng(0)
    for d in ("clean", "noisy"):
        os.makedirs(root / d)
    for i in range(8):
        t = np.arange(SR + i * 2048) / SR
        clean = (0.1 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(
            np.float32)
        noise = rng.standard_normal(len(t)).astype(np.float32) * 0.02
        write_wav(str(root / "clean" / f"f{i:02d}.wav"), clean, SR)
        write_wav(str(root / "noisy" / f"f{i:02d}.wav"), clean + noise, SR)
    return str(root / "clean"), str(root / "noisy")


def _argv(name, logs, clean, noisy, batch):
    mk = dict(TINY_KWARGS, rnnformer_kwargs=dict(
        TINY_KWARGS["rnnformer_kwargs"], num_blocks=1))
    params = [f"model_kwargs={mk!r}", "train.max_epochs=2",
              "train.save_interval=2", "train.seed=11", "train.fp16=False",
              f"train.batch_size={batch}", "train.num_workers=1",
              f"valid.batch_size={batch}",
              "train.losses={'si_snr': {'weight': 1.0}, "
              "'mag_mse': {'weight': 1.0}}",
              "train.optimizer_kwargs={'lr': 0.002, 'weight_decay': 0.01, "
              "'betas': [0.95, 0.999], 'wd_ratio': 1.0, "
              "'projection': 'disabled', 'eps': 1e-4}",
              "train.optimizer_groups=None", "pesq.interval=99",
              "infer.interval=99", "data.infer.files=['f00']"]
    for mode in ("train", "valid", "pesq", "infer"):
        params += [f"data.{mode}.clean_dir={clean}",
                   f"data.{mode}.noisy_dir={noisy}"]
    for mode in ("train", "valid"):
        params.append(f"data.{mode}.segment_size=None")
    return ["-n", name, "-c", os.path.join(tp.REPO, "configs", "fastenhancer",
                                           "t.yaml"),
            "--base_dir", logs, "-p", *params]


def _valid_line(text):
    line = [ln for ln in text.splitlines() if ln.startswith("Epoch 2/")]
    assert line, text[-2000:]
    toks = line[0].split("valid:")[1].split("[")[0].split()
    return {toks[i]: float(toks[i + 1]) for i in range(0, len(toks), 2)}


def test_cli_two_ranks_equal_one_process_at_twice_the_batch(tmp_path,
                                                            capsys):
    clean, noisy = _corpus(tmp_path / "wav")
    logs = str(tmp_path / "logs")
    out_dir = tmp_path / "ranks"
    out_dir.mkdir()
    join = dist_.start(dist_.cli_worker, WORLD, str(out_dir),
                       _argv("multi", logs, clean, noisy, 2))
    main(_argv("single", logs, clean, noisy, 4) + ["--device", "cpu"])
    single_out = capsys.readouterr().out
    join()
    v1 = load_checkpoint(os.path.join(logs, "single", "00002.ckpt"))
    v2 = load_checkpoint(os.path.join(logs, "multi", "00002.ckpt"))
    a = flatten_paths(v1["variables"])
    b = flatten_paths(v2["variables"])
    assert a.keys() == b.keys() and a
    for path in a:
        np.testing.assert_allclose(np.asarray(b[path]), np.asarray(a[path]),
                                   rtol=5e-4, atol=1e-6, err_msg=str(path))

    run = os.path.join(logs, "multi")
    assert sorted(os.listdir(run)) == ["00002.ckpt", "config.yaml", "train",
                                       "valid"]
    logs_ = [open(out_dir / f"rank{r}.log").read() for r in range(WORLD)]
    assert "Epoch 2/2" in logs_[0] and "rank 0 of 2" in logs_[0]
    assert "Epoch" not in logs_[1] and "rank 1 of 2" in logs_[1]
    single, multi = _valid_line(single_out), _valid_line(logs_[0])
    assert single.keys() == multi.keys()
    for k, v in single.items():
        np.testing.assert_allclose(multi[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)
