"""Several processes over `torch.distributed`: data-parallel training.

Counterpart of fastenhancer_tpu/parallel/__init__.py. The JAX package runs
one process per host with a mesh over that host's chips, jits the train
step over the global batch and lets XLA insert the gradient psum and the
global-batch BatchNorm statistics. The port runs one process per card (W
processes in all, rank r on its own card) and does both by hand:

* `nn/layers.py::batch_norm` in train mode all-reduces its sums [sum w*x,
  sum w*x^2, sum w] through `all_reduce_sum`, a differentiable all-reduce,
  so every rank normalises with the statistics of every real row;
* each rank's loss is its local row sum over the all-reduced count of real
  rows (`losses.py`), so the ranks' losses add up to the global mean, and
  `train/step.py` sums the gradients over the ranks in one flat bucket
  (`all_reduce_flat`); the backward of the BN all-reduce has already added
  the cross-rank terms;
* the ranks agree on each step's batch shape with `all_gather_ints`
  (`wrappers/ns.py::_reconcile_multihost`).

So W ranks at batch B take the step of one process at batch W*B. The JAX
module's other functions have no counterpart, because one process holds
one card: `make_mesh`, `batch_sharding`, `replicated` and `replicate` (each
rank holds a whole copy of the state; one seed or one checkpoint makes the
copies equal and the summed gradients keep them so), `shard_batch` and
`local_rows` (a rank's batch is its own rows, on its own card, already),
and `shard_map_stream` (the serving engine runs one step per shard itself,
serving.py).

Without a process group, `world()` is 1 and `rank()` 0, and every function
here leaves its input as it is.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor


def init(coordinator: str, num_processes: int, process_id: int,
         backend: tp.Optional[str] = None,
         device: tp.Union[str, torch.device, None] = None) -> torch.device:
    """Join the process group of `num_processes` ranks as `process_id`;
    `coordinator` is rank 0's "host:port". `device` is this rank's device,
    by default card `process_id % device_count` (RuntimeError without a
    card); the backend is NCCL when it is a card and gloo on the CPU,
    unless `backend` names one (gloo on a card). One all-reduce checks the
    group, so a backend that cannot start raises here. Returns the
    device."""
    if device is None:
        from .. import require_cuda

        require_cuda()
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    one = torch.ones(1, device=_comm_device())
    dist.all_reduce(one)
    if int(one.item()) != num_processes:
        raise RuntimeError(f"the process group's all-reduce gave "
                           f"{one.item()}, not {num_processes}")
    return device


def destroy() -> None:
    """Leave the process group, where there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world() -> int:
    """The number of ranks; 1 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _comm_device() -> torch.device:
    """Where the host-side collectives put their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(local: np.ndarray) -> np.ndarray:
    if world() == 1:
        return local[None]
    t = torch.from_numpy(local).to(_comm_device())
    out = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def all_gather_ints(values: tp.Sequence[int]) -> np.ndarray:
    """[world, len(values)] int64: every rank's `values`, by rank (as
    many on every rank)."""
    return _all_gather(np.asarray(values, np.int64).reshape(-1))


def all_gather_floats(values: tp.Sequence[float]) -> np.ndarray:
    """[world, len(values)] float32: every rank's `values`, by rank."""
    return _all_gather(np.asarray(values, np.float32).reshape(-1))


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum over the ranks of
    the incoming gradients (every rank's loss depends on every rank's
    input)."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: Tensor) -> Tensor:
    """The sum of `x` over the ranks, differentiable."""
    if world() == 1:
        return x
    return _AllReduceSum.apply(x)


def all_reduce_flat(tensors: tp.Sequence[Tensor]) -> tp.List[Tensor]:
    """Each tensor summed over the ranks, all in one all-reduce of one
    flat bucket (one dtype and device); new tensors, no gradient."""
    tensors = list(tensors)
    if world() == 1 or not tensors:
        return tensors
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()
    return out


def pad_batch_to(batch: tp.Dict[str, np.ndarray], multiple: int
                 ) -> tp.Tuple[tp.Dict[str, np.ndarray], int]:
    """Pad the leading axis of every array with zero rows up to a multiple;
    returns (padded batch, original batch size)."""
    sizes = {np.shape(x)[0] for x in batch.values()}
    assert len(sizes) == 1, f"inconsistent batch sizes: {sizes}"
    b = sizes.pop()
    pad = (-b) % multiple
    if pad == 0:
        return batch, b

    def _pad(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    return {k: _pad(x) for k, x in batch.items()}, b


__all__ = ["init", "destroy", "world", "rank", "all_gather_ints",
           "all_gather_floats",
           "all_reduce_sum", "all_reduce_flat", "pad_batch_to"]
