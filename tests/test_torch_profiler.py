"""The train loop's instrumentation on the CPU: the port's step-window
profiler (utils/profiler.py, on torch.profiler) in the three behaviours
tests/test_profiler.py pins on the JAX package's (one trace written where
the run's profile dir is, one window per run even when the epoch ends
inside it, the same `train.profile` parsing), which steps its window
holds, the wrapper's hook and histograms, and the gradients the train
step returns for them against JAX's (3e-3 of a leaf's largest value, as
tests/_torch_train_parity.py)."""
import copy
import glob
import json
import os

import numpy as np
import pytest
import torch

from fastenhancer_tpu_torch.losses import Losses
from fastenhancer_tpu_torch.optim import get_optimizer
from fastenhancer_tpu_torch.presets import FE_T_SHARD
from fastenhancer_tpu_torch.train import make_train_step
from fastenhancer_tpu_torch.utils import tree_paths
from fastenhancer_tpu_torch.utils.hparams import HParams
from fastenhancer_tpu_torch.utils.profiler import StepProfiler, make_profiler
from fastenhancer_tpu_torch.wrappers import get_wrapper

from _torch_parity import (TINY_KWARGS, real_triton_only,
                           torch_one_thread)  # noqa: F401
from _torch_train_parity import assert_grads_close, build_case, run_jax_steps

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")


def _traces(logdir):
    return glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                     recursive=True)


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_window_capture_writes_trace(tmp_path):
    logdir = str(tmp_path / "profile")
    prof = StepProfiler(logdir, start=2, steps=3)
    x = torch.ones(8, 8)
    for i in range(7):
        with torch.profiler.record_function(f"step{i}"):
            float((x * 2.0 + 1.0).sum())
        prof.step()
    assert prof.done and not prof.active
    (trace,) = _traces(logdir)
    assert prof.trace_path == trace
    names = _names(trace)
    # open after step 2's dispatch, closed after step 4's
    assert {"step3", "step4"} <= names
    assert not names & {"step0", "step1", "step2", "step5", "step6"}


def test_epoch_end_inside_window_closes_once(tmp_path):
    logdir = str(tmp_path / "profile")
    prof = StepProfiler(logdir, start=0, steps=100)
    prof.step()
    prof.close()  # epoch ended mid-window
    assert prof.done
    prof.step()  # further steps are no-ops, no second trace is opened
    prof.close()
    assert len(_traces(logdir)) == 1


def test_make_profiler_parses_config(tmp_path):
    base = str(tmp_path)
    assert make_profiler(HParams(), base) is None
    assert make_profiler(HParams(profile=False), base) is None

    prof = make_profiler(HParams(profile=True), base)
    assert prof is not None and (prof.start, prof.stop) == (10, 15)
    assert prof.logdir == os.path.join(base, "profile")
    assert not prof.cuda

    prof = make_profiler(HParams(profile={"start": 3, "steps": 2}), base)
    assert (prof.start, prof.stop) == (3, 5)
    prof = make_profiler({"profile": {"start": 1, "steps": 2,
                                      "logdir": "elsewhere"}}, base,
                         device="cuda")
    assert (prof.start, prof.stop, prof.logdir) == (1, 3, "elsewhere")
    assert prof.cuda  # CUDA activity on a card (nothing opened here)


def test_wrapper_hook_and_histograms(tmp_path):
    """The ns wrapper with train.profile and plot_param_and_grad: one trace
    under {base_dir}/profile, closed at the epoch's end; the train summary
    holds every param leaf and its last step's gradient."""
    hps = copy.deepcopy(FE_T_SHARD)
    hps["model_kwargs"] = dict(TINY_KWARGS)
    hps["base_dir"] = str(tmp_path)
    hps["train"].update(fp16=False, plot_param_and_grad=True,
                        profile={"start": 1, "steps": 5})
    w = get_wrapper("ns")(HParams(**hps), train=True, device="cpu")
    rng = np.random.default_rng(0)
    batches = [{"clean": (rng.standard_normal((2, 64 * 12)) * 0.1)
                .astype(np.float32),
                "noisy": (rng.standard_normal((2, 64 * 12)) * 0.1)
                .astype(np.float32)} for _ in range(3)]
    summary = w.train_epoch(batches)
    assert w.profiler.done
    (trace,) = _traces(str(tmp_path / "profile"))
    assert "aten::mm" in _names(trace)
    paths = ["/".join(p) for p, _ in tree_paths(
        w.state["variables"]["params"])]
    assert set(summary["hists"]) == {f"{k}/{p}" for k in ("param", "grad")
                                     for p in paths}
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in summary["hists"].values())


def test_return_grads_matches_jax():
    """make_train_step(return_grads=True) puts the step's float32
    gradients in the params' tree, each leaf within GRAD_REL of JAX's
    (its jitted step with return_grads, from one state); without it the
    metrics hold no gradients."""
    case = build_case("fastenhancer.default", TINY_KWARGS,
                      "fastenhancer_shard/t.yaml")
    (_, _, jgrads, _, _), = run_jax_steps(case["jm"], case["jv"], case["hp"],
                                          case["batch"], steps=1)
    tm, tv, hp = case["tm"], case["tv"], case["hp"]
    opt = get_optimizer(tm, tv["params"], hp)
    step = make_train_step(tm, Losses(hp["losses"]), opt, return_grads=True)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    paths = [p for p, _ in tree_paths(tv["params"])]
    _, metrics = step({"variables": tv}, batch, [1e-3] * opt.n_groups)
    grads = dict(tree_paths(metrics["grads"]))
    assert list(grads) == paths
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert_grads_close(grads, jgrads)
    _, metrics = make_train_step(
        tm, Losses(hp["losses"]), get_optimizer(tm, tv["params"], hp))(
        {"variables": tv}, batch, [1e-3] * opt.n_groups)
    assert "grads" not in metrics


