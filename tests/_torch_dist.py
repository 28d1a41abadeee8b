"""Several gloo ranks on the CPU for the port's tests: `spawn` starts W
processes with a deadline, and the workers here run in them. This module
imports torch and the port only, so a rank starts without JAX."""
import contextlib
import os
import socket
import time

import torch
import torch.multiprocessing as mp

SPAWN_TIMEOUT = 240  # seconds for all ranks; a hang fails, it does not wait


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(fn, world, *args, timeout=SPAWN_TIMEOUT):
    """fn(rank, world, coordinator, *args) in `world` spawned processes,
    joined into one gloo group by the worker. Returns `join()`, which
    waits for them and raises if a rank raised or the ranks are not done
    within `timeout` seconds of the start (then every rank is killed)."""
    coordinator = f"127.0.0.1:{free_port()}"
    ctx = mp.start_processes(_run, args=(fn, world, coordinator) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout

    def join():
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks not done in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    return join


def spawn(fn, world, *args, timeout=SPAWN_TIMEOUT):
    """start(...), then join()."""
    start(fn, world, *args, timeout=timeout)()


def _run(rank, fn, world, coordinator, *args):
    torch.set_num_threads(1)
    fn(rank, world, coordinator, *args)


def _join(rank, world, coordinator):
    from fastenhancer_tpu_torch import parallel

    parallel.init(coordinator, world, rank, device="cpu")
    return parallel


def bn_worker(rank, world, coordinator, out_dir, inputs):
    """batch_norm(train=True) on this rank's rows: the output, the running
    statistics and the gradients of sum(y * g) for x, weight and bias."""
    from fastenhancer_tpu_torch.nn.layers import batch_norm

    parallel = _join(rank, world, coordinator)
    x = torch.from_numpy(inputs["x"][rank]).requires_grad_(True)
    params = {k: torch.from_numpy(inputs[k]).requires_grad_(True)
              for k in ("weight", "bias")}
    stats = {k: torch.from_numpy(inputs[k]) for k in ("mean", "var")}
    y, new = batch_norm(params, stats, x, train=True,
                        weight=torch.from_numpy(inputs["w"][rank]))
    (y * torch.from_numpy(inputs["g"][rank])).sum().backward()
    out = {"y": y, "x_grad": x.grad, "weight_grad": params["weight"].grad,
           "bias_grad": params["bias"].grad, **new}
    torch.save({k: v.detach().numpy() for k, v in out.items()},
               os.path.join(out_dir, f"rank{rank}.pt"))
    parallel.destroy()


def step_worker(rank, world, coordinator, out_dir, case):
    """One float32 train step of the port on this rank's rows of the
    global batch: the metrics, the summed gradients and the variables
    after it."""
    from fastenhancer_tpu_torch.losses import Losses
    from fastenhancer_tpu_torch.models import get_model
    from fastenhancer_tpu_torch.optim import get_optimizer, get_scheduler
    from fastenhancer_tpu_torch.train import make_train_step
    from fastenhancer_tpu_torch.utils import tree_map, tree_paths

    parallel = _join(rank, world, coordinator)
    model = get_model(case["model"], **case["kwargs"])
    variables = tree_map(torch.from_numpy, case["variables"])
    hp = case["hp"]
    opt = get_optimizer(model, variables["params"], hp)
    lrs = list(get_scheduler(opt, hp).lrs)
    step = make_train_step(model, Losses(hp["losses"]), opt,
                           return_grads=True)
    batch = {k: torch.from_numpy(v[rank]) for k, v in case["batch"].items()}
    state, metrics = step({"variables": variables}, batch, lrs)
    grads = metrics.pop("grads")
    torch.save({
        "lrs": lrs, "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {p: g.numpy() for p, g in tree_paths(grads)},
        "variables": tree_map(lambda t: t.detach().numpy(),
                              state["variables"])},
        os.path.join(out_dir, f"rank{rank}.pt"))
    parallel.destroy()


def cli_worker(rank, world, coordinator, out_dir, argv):
    """The training CLI as rank `rank` of `world` (its own flags), its
    standard output written to out_dir/rank{rank}.log."""
    from fastenhancer_tpu_torch.train.__main__ import main

    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        main(list(argv) + ["--device", "cpu", "--coordinator", coordinator,
                           "--num_processes", str(world),
                           "--process_id", str(rank)])


def load_ranks(out_dir, world):
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]

