"""The train, valid and inference steps.

Counterpart of fastenhancer_tpu/train/step.py. A train step is
{state, batch, lrs} -> {state, metrics}, where state is {"variables":
{"params", "stats"}}. The optimizer holds the param leaves and their
moments, so the step updates the params in place and returns the state
with the new BatchNorm statistics.

Mixed precision as the JAX package does it: with compute_dtype (bfloat16)
the float32 master params are cast inside the loss function (a
differentiable `.to`, not torch.autocast), so the forward and backward run
in bfloat16 and the gradients arrive in float32 on the masters; the
losses run in float32 and the BN statistics are stored in float32. There
is no gradient scaler: bfloat16 has float32's exponent range.

Every param leaf, frozen ones included, gets a gradient, so the reported
grad norm is the JAX step's; the optimizer updates only its groups'
leaves.

Under several ranks (`parallel`), each rank's loss is its share of the
global batch's mean (`Losses.calculate`), so the step sums the gradients
over the ranks, in one flat all-reduce, before the clipper and the
non-finite check; every rank then takes the same branch and the same
update. The reported losses are summed over the ranks the same way: each
step, train or valid, reports the global batch's values on every rank.
"""
from __future__ import annotations

import typing as tp

import torch

from .. import parallel
from ..losses import Losses
from ..optim import GroupedOptimizer
from ..utils.tree import cast_floating, tree_leaves, tree_map
from .grad_clip import make_clipper

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


def _truncate(model, batch: Params) -> tp.Tuple[Tensor, Tensor]:
    """clean, noisy cut to a multiple of the hop."""
    hop = model.hop_size
    t = (batch["clean"].shape[-1] // hop) * hop
    return batch["clean"][..., :t], batch["noisy"][..., :t]


def _global_losses(total: Tensor, per_loss: tp.Dict[str, Tensor]
                   ) -> tp.Dict[str, Tensor]:
    """{"loss/total", "loss/<name>"}, detached, each summed over the ranks
    (one all-reduce; as they are on one rank)."""
    vals = parallel.all_reduce_flat(
        [total.detach()] + [v.detach() for v in per_loss.values()])
    return dict(zip(["loss/total"] + [f"loss/{k}" for k in per_loss], vals))


def make_train_step(model, losses: Losses, optimizer: GroupedOptimizer,
                    clip_grad: tp.Optional[str] = None,
                    clip_grad_kwargs: tp.Optional[
                        tp.Mapping[str, tp.Any]] = None,
                    compute_dtype: tp.Optional[torch.dtype] = None,
                    skip_nonfinite: bool = False,
                    return_grads: bool = False):
    """The train step. compute_dtype=torch.bfloat16 casts the params and
    wavs for the forward and backward; master params, moments and BN
    statistics stay float32. skip_nonfinite keeps the old params, moments
    and statistics when any gradient is NaN or Inf (one host read of a
    flag per step, so only when asked for). return_grads puts the step's
    float32 gradients, clipped, in the params' tree under metrics["grads"]
    (for train.plot_param_and_grad's histograms)."""
    clipper = make_clipper(clip_grad, clip_grad_kwargs)

    def loss_fn(params: Params, stats: Params, clean: Tensor, noisy: Tensor,
                row_mask: tp.Optional[Tensor]
                ) -> tp.Tuple[Tensor, tp.Dict[str, Tensor], Params]:
        if compute_dtype is not None:
            fwd_params = cast_floating(params, compute_dtype)
            noisy_c, clean_c = noisy.to(compute_dtype), clean.to(compute_dtype)
        else:
            fwd_params, noisy_c, clean_c = params, noisy, clean
        wav_hat, spec_hat, new_stats = model.forward(
            {"params": fwd_params, "stats": stats}, noisy_c, train=True,
            row_mask=row_mask)
        spec_clean = model.stft(clean_c)
        total, per_loss = losses.calculate(
            wav_hat.float(), spec_hat.float(), clean.float(),
            spec_clean.float(), row_mask=row_mask)
        return total, per_loss, cast_floating(new_stats, torch.float32)

    def train_step(state: Params, batch: Params, lrs: tp.Sequence[float]
                   ) -> tp.Tuple[Params, tp.Dict[str, Tensor]]:
        variables = state["variables"]
        params = variables["params"]
        # rows zero-padded to fill a batch are left out of the losses and
        # the train-mode BN statistics
        row_mask = batch.get("row_mask")
        clean, noisy = _truncate(model, batch)
        leaves = tree_leaves(params)
        # the leaves are tracked only while the loss is taken: the params
        # leave the step untracked, so fold(), stream() and the serving
        # engine build no graph on trained variables
        for p in leaves:
            p.requires_grad_(True)
        try:
            total, per_loss, new_stats = loss_fn(params, variables["stats"],
                                                 clean, noisy, row_mask)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = parallel.all_reduce_flat(
            [torch.zeros_like(p) if g is None else g.float()
             for p, g in zip(leaves, grads)])
        grads, gnorm = clipper(grads)
        reported = _global_losses(total, per_loss)
        metrics = {"loss/total": reported.pop("loss/total"),
                   "grad_norm": gnorm, **reported}
        if return_grads:
            it = iter(grads)
            metrics["grads"] = tree_map(lambda _: next(it), params)
        finite = True
        if skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all()
                                       for g in grads]).all())
            metrics["skipped"] = torch.tensor(0.0 if finite else 1.0)
        if not finite:
            return state, metrics
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.set_lrs(lrs)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        new_stats = tree_map(lambda t: t.detach(), new_stats)
        return {"variables": {"params": params, "stats": new_stats}}, metrics

    return train_step


def make_valid_step(model, losses: Losses,
                    compute_dtype: tp.Optional[torch.dtype] = None):
    """Forward and losses only, eval-mode BN (running statistics)."""

    @torch.no_grad()
    def valid_step(variables: Params, batch: Params) -> tp.Dict[str, Tensor]:
        row_mask = batch.get("row_mask")  # eval BN uses running stats; only
        clean, noisy = _truncate(model, batch)  # the loss means mask rows
        params = variables["params"]
        if compute_dtype is not None:
            params = cast_floating(params, compute_dtype)
            noisy = noisy.to(compute_dtype)
        wav_hat, spec_hat, _ = model.forward(
            {"params": params, "stats": variables["stats"]}, noisy)
        spec_clean = model.stft(clean)
        total, per_loss = losses.calculate(
            wav_hat.float(), spec_hat.float(), clean.float(),
            spec_clean.float(), row_mask=row_mask)
        return _global_losses(total, per_loss)

    return valid_step


def make_infer_fn(model, compute_dtype: tp.Optional[torch.dtype] = None):
    """noisy wav -> enhanced wav (the offline graph), float32."""

    @torch.no_grad()
    def infer(variables: Params, noisy: Tensor) -> Tensor:
        params = variables["params"]
        if compute_dtype is not None:
            params = cast_floating(params, compute_dtype)
            noisy = noisy.to(compute_dtype)
        wav_hat, _, _ = model.forward(
            {"params": params, "stats": variables["stats"]}, noisy)
        return wav_hat.float()

    return infer
