"""The loop that every streaming model's `stream` runs."""
from __future__ import annotations

import typing as tp

import torch

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


def stream_hops(model, variables: Params, wav: Tensor, chunk_frames: int,
                fused_plan: tp.Optional[Params]) -> Tensor:
    """`model.streaming_step` (or `streaming_step_fused` with a plan) a hop
    at a time, or with chunk_frames=C > 1 `model.streaming_chunk` over C
    hops at a time, the tail cut to a multiple of C. A plan with C > 1
    raises ValueError, as in the JAX package (a fused chunked step is not
    implemented)."""
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, not {chunk_frames}")
    if fused_plan is not None and chunk_frames > 1:
        raise ValueError("fused_plan implies per-frame streaming "
                         "(chunk_frames=1); a fused chunked step is not "
                         "implemented")
    b, length = wav.shape
    step = model.hop_size * chunk_frames
    n = length // step
    carry = model.init_streaming_carry(b, wav.dtype, wav.device,
                                       fused=fused_plan is not None)
    outs = []
    for i in range(n):
        x = wav[:, i * step:(i + 1) * step]
        if chunk_frames > 1:
            carry, y = model.streaming_chunk(variables, carry, x)
        elif fused_plan is None:
            carry, y = model.streaming_step(variables, carry, x)
        else:
            carry, y = model.streaming_step_fused(variables, fused_plan,
                                                  carry, x)
        outs.append(y)
    return torch.cat(outs, dim=1) if outs else wav[:, :0]
