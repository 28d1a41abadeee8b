"""The loop that every streaming model's `stream` runs, and the streaming
step of the models that mask the whole compressed spectrum."""
from __future__ import annotations

import typing as tp

import torch

from ..functional import (compress, uncompress, stft_streaming_chunk,
                          istft_streaming_chunk)

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


def spectral_step(model, carry: Params, wav: Tensor,
                  network: tp.Callable[[Tensor], tp.Tuple[Tensor, tp.Any]]
                  ) -> tp.Tuple[Params, Tensor]:
    """One streaming step of a model over all n_fft/2 + 1 bins of the
    compressed spectrum (BSRNN, FSPEN, LiSenNet): the STFT of the step's
    hops (wav [B, hop*C]), compress, `network` (spec [B, F, C, 2] ->
    (spec_hat, the new carry's "h")), uncompress, the iSTFT overlap-add ->
    (new carry {"stft", "istft", "h"}, wav_out [B, hop*C])."""
    spec, stft_c = stft_streaming_chunk(wav, carry["stft"], model.stft_cfg)
    spec_hat, h = network(compress(spec, model.input_compression))
    wav_out, istft_c = istft_streaming_chunk(
        uncompress(spec_hat, model.input_compression), carry["istft"],
        model.stft_cfg)
    return {"stft": stft_c, "istft": istft_c, "h": h}, wav_out


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
