"""FastEnhancer's noncausal (offline) variant, inference, in PyTorch.

Counterpart of fastenhancer_tpu/models/fastenhancer/noncausal.py (the
reference's "huge_noncausal" recipes, models/fastenhancer/noncausal/
model.py). It differs from the default model in three places:

* each block's time GRU is bidirectional, and rnn_fc maps 2C -> C
  (:186-187); in eval each direction is one gru_scan launch
  (ops/gru_scan.py::bigru_fused), so a forward makes two a block;
* the fixed frequency filterbank is built on the absolute-Hz grid, with
  linear init only (:308-345);
* there is no streaming graph (the reference has no ONNXModel, :348):
  every streaming entry point raises NotImplementedError, as in JAX.

`forward(train=True, row_mask=...)` trains it (JAX noncausal.py:95-139):
the default model's train-mode BN, and the biGRU as nn.bigru's
differentiable loop over both directions.
"""
from __future__ import annotations

import typing as tp

import torch

from ... import nn as fnn
from ...ops.gru_scan import bigru_fused
from .default import Model as DefaultModel, Params, Tensor
from .dptransformer import set_ablation_filterbanks

_NO_STREAMING = ("the noncausal model has no streaming graph (the reference "
                 "has no ONNXModel either)")
_DIRECTIONS = ("fwd", "bwd")


class Model(DefaultModel):
    """FastEnhancer noncausal. Takes the reference's `model_kwargs`
    unchanged (configs/fastenhancer_dns/huge_noncausal.yaml)."""

    spec2spec_fused = False  # offline only: no streaming step

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.pre_post_init not in (None, "linear", "linear_fixed"):
            raise ValueError("noncausal supports only linear filterbank init, "
                             f"not {self.pre_post_init!r}")

    def init(self, generator: torch.Generator,
             device: tp.Union[str, torch.device]) -> tp.Dict[str, Params]:
        """The default model's tree with bidirectional-GRU blocks and, with
        a pre_post_init, the absolute-Hz linear filterbanks."""
        dev = torch.device(device)
        variables = super().init(generator, dev)
        if self.pre_post_init is not None:
            set_ablation_filterbanks(variables["params"], self.freq,
                                     self.rf.freq, self.pre_post_init,
                                     self.sampling_rate, dev)
        return variables

    # -- the bidirectional time GRU (the default model's hooks) ---------------

    def _time_rnn_init(self, g: torch.Generator, ch: int,
                       dev: torch.device) -> tp.Tuple[Params, int]:
        """-> ({"fwd", "bwd"} GRU params, 2C: rnn_fc maps 2C -> C)."""
        rnn = fnn.init_bigru(g, ch, ch, dev)
        if self.weight_norm:
            for d in _DIRECTIONS:
                rnn[d]["weight_ih"] = fnn.to_wn(rnn[d]["weight_ih"])
                rnn[d]["weight_hh"] = fnn.to_wn(rnn[d]["weight_hh"])
        return rnn, 2 * ch

    def _time_rnn_apply(self, p: Params, y: Tensor, h0: tp.Optional[Tensor],
                        train: bool) -> tp.Tuple[Tensor, Tensor]:
        """y [T, N, C] -> (ys [T, N, 2C] in [fwd, bwd] order, an empty
        carry: a bidirectional GRU has no streaming state); h0 unused. Two
        gru_scan launches in eval (ops/gru_scan.py::bigru_fused), nn.bigru's
        loop in train."""
        bigru = fnn.bigru if train else bigru_fused
        return bigru(p, y), y.new_zeros(0)

    def _time_rnn_fold(self, rnn: Params, pre_norm: tp.Optional[Params]
                       ) -> Params:
        """The default model's fold of each direction."""
        fold = super()._time_rnn_fold
        return {d: fold(rnn[d], pre_norm) for d in _DIRECTIONS}

    # -- no streaming -------------------------------------------------------

    def init_streaming_carry(self, *args, **kwargs):
        raise NotImplementedError(_NO_STREAMING)

    def streaming_step(self, *args, **kwargs):
        raise NotImplementedError(_NO_STREAMING)

    def streaming_chunk(self, *args, **kwargs):
        raise NotImplementedError(_NO_STREAMING)

    def torch_name(self, path: tp.Tuple[str, ...]) -> str:
        """The bidirectional GRU's leaves map to torch's *_l0 (forward) and
        *_l0_reverse (backward) names; every other path as the default's."""
        if path[0] == "rf_blocks" and len(path) > 2 and path[2] == "rnn":
            i, direction, leaf = path[1], path[3], path[4]
            sub = path[5] if len(path) > 5 else None
            suffix = "_l0" if direction == "fwd" else "_l0_reverse"
            prefix = f"rf_block.{i}.rnn"
            if leaf.startswith("weight"):
                name = leaf + suffix
                if sub is None:
                    return f"{prefix}.{name}"
                which = "original0" if sub == "g" else "original1"
                return f"{prefix}.parametrizations.{name}.{which}"
            return f"{prefix}.{leaf}{suffix}"
        return super().torch_name(path)
