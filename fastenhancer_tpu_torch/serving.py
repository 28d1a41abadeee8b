"""Slot-based streaming serving engine: streams join and leave one batch.

Counterpart of fastenhancer_tpu/serving.py, on one device. Many concurrent
streams share one per-hop step over a fixed-capacity batch. Streams arrive
and finish at different times, so the engine owns a slot pool over one
carry and lets callers open and close streams between ticks.

* **Fixed capacity.** The batch axis is `capacity`; inactive slots process
  silence.
* **O(1) slot reset.** A new stream needs its slot's state (STFT/iSTFT
  caches, GRU carries) re-initialised. The engine infers once which axis of
  every carry leaf scales with the batch, by comparing
  `init_streaming_carry(1)` with `init_streaming_carry(capacity)` leaf
  shapes, and resets slot i by copying the fresh one-stream state into that
  slot's rows of each leaf in place. The inference assumes batch-major
  packing of merged axes (GRU rows [b0f0..b0fF, b1f0..]), which is how the
  model packs its carries; the slot-isolation test is what proves it.
* **Stable carry structure.** Every tick checks that the step returned a
  carry of the same structure, shapes and dtypes, since the slot axes and
  the reset depend on it.

Typical use:

    engine = StreamingEngine(model, variables, capacity=256,
                             dtype=torch.bfloat16, fused=True, device="cuda")
    h = engine.open_stream()
    for hop_samples in hops:                  # [hop] each
        out = engine.tick({h: hop_samples})   # {handle: [hop]}
    tail = engine.flush(h)                    # drain the n_fft-hop delay
    engine.close_stream(h)

Sharding the slots over several devices (`devices>1` in the JAX engine) is
not ported yet (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import functools
import typing as tp

import numpy as np
import torch

from .utils.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Params = tp.Dict[str, tp.Any]


def _slot_axes(one_leaves: tp.List[Tensor], full_leaves: tp.List[Tensor],
               capacity: int) -> tp.List[tp.Optional[int]]:
    """For each carry leaf, the axis that scales linearly with the batch:
    the unique axis where full = capacity * one while every other axis
    matches. None = the leaf does not depend on the batch."""
    axes: tp.List[tp.Optional[int]] = []
    for one, full in zip(one_leaves, full_leaves):
        if one.shape == full.shape:
            axes.append(None)
            continue
        if one.ndim != full.ndim:
            raise ValueError(
                f"carry leaf rank changed with batch: {tuple(one.shape)} vs "
                f"{tuple(full.shape)}; cannot infer the slot axis")
        cand = [a for a in range(one.ndim)
                if full.shape[a] == capacity * one.shape[a]
                and all(full.shape[b] == one.shape[b]
                        for b in range(one.ndim) if b != a)]
        if len(cand) != 1:
            raise ValueError(
                f"ambiguous slot axis for carry leaf {tuple(one.shape)} -> "
                f"{tuple(full.shape)} at capacity {capacity}: {cand}")
        axes.append(cand[0])
    return axes


def _signature(carry: Params) -> tp.Any:
    return tree_map(lambda t: (tuple(t.shape), t.dtype), carry)


class StreamingEngine:
    """Fixed-capacity dynamic-batching engine over one model's streaming
    step, on one device.

    Args:
      model: exposes `init_streaming_carry(batch, dtype, device, fused=)`
        and `streaming_step(variables, carry, hops)`; with fused=True also
        `build_stack_plan` and `streaming_step_fused` (folded variables).
      variables: parameter tree, fold()ed when fused=True, with every float
        leaf already of `dtype` and on `device`.
      capacity: slot count == batch size of every step; at least 2 (the
        slot axes are inferred from how shapes scale with it).
      dtype: carry and activation dtype (bfloat16 for serving).
      fused: run the block stack as one kernel per tick.
      device: where the carry lives and the step runs.
    """

    def __init__(self, model, variables: Params, capacity: int,
                 dtype: torch.dtype = torch.float32, fused: bool = False, *,
                 device: tp.Union[str, torch.device]):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.model = model
        self.capacity = capacity
        self.dtype = dtype
        self.device = torch.empty(0, device=device).device  # e.g. cuda -> cuda:0
        self.hop = model.stft_cfg.hop_size
        self.delay_samples = model.stft_cfg.n_fft - self.hop
        # The engine's contract: the variables are already of `dtype` and on
        # `device`. A mismatch would fail later with an opaque dtype or
        # device error deep inside a conv or the kernel wrapper.
        for leaf in tree_leaves(variables):
            if leaf.is_floating_point() and leaf.dtype != dtype:
                raise ValueError(
                    f"StreamingEngine(dtype={dtype}) requires the variables "
                    f"cast to that dtype (found {leaf.dtype} leaves); cast "
                    "them first, e.g. utils.cast_floating(variables, dtype)")
            if leaf.device != self.device:
                raise ValueError(
                    f"StreamingEngine(device={self.device}) requires the "
                    f"variables on that device (found a leaf on "
                    f"{leaf.device})")
        self._carry = model.init_streaming_carry(capacity, dtype, self.device,
                                                 fused=fused)
        one = model.init_streaming_carry(1, dtype, self.device, fused=fused)
        self._one_leaves = tree_leaves(one)
        self._axes = _slot_axes(self._one_leaves, tree_leaves(self._carry),
                                capacity)
        self._signature = _signature(self._carry)
        if fused:
            plan = model.build_stack_plan(variables, dtype=dtype)
            self._step = functools.partial(model.streaming_step_fused,
                                           variables, plan)
        else:
            self._step = functools.partial(model.streaming_step, variables)
        self._slot_of: tp.Dict[int, int] = {}        # handle -> slot
        self._free = list(range(capacity - 1, -1, -1))
        self._next_handle = 0

    # -- slot lifecycle ------------------------------------------------------

    def _reset(self, slot: int) -> None:
        """Re-initialise one slot's rows in every carry leaf, in place."""
        for leaf, fresh, axis in zip(tree_leaves(self._carry),
                                     self._one_leaves, self._axes):
            if axis is not None:
                per = fresh.shape[axis]
                leaf.narrow(axis, slot * per, per).copy_(fresh)

    def open_stream(self) -> int:
        """Claim a slot with fresh state; returns a handle for tick()."""
        if not self._free:
            raise RuntimeError(f"engine full ({self.capacity} streams)")
        slot = self._free.pop()
        handle = self._next_handle
        self._next_handle += 1
        self._slot_of[handle] = slot
        self._reset(slot)
        return handle

    def close_stream(self, handle: int) -> None:
        slot = self._slot_of.pop(handle)   # KeyError on unknown handle
        self._free.append(slot)

    @property
    def active(self) -> int:
        return len(self._slot_of)

    # -- data path -----------------------------------------------------------

    def tick(self, hops: tp.Dict[int, np.ndarray]) -> tp.Dict[int, np.ndarray]:
        """Advance every stream by one hop.

        hops: {handle: [hop] samples} for any subset of active handles;
        absent handles are fed silence (their clock still advances).
        Returns {handle: [hop] enhanced float32 samples} for the handles
        given, delayed by `delay_samples`."""
        buf = np.zeros((self.capacity, self.hop), np.float32)
        for handle, wav in hops.items():
            slot = self._slot_of[handle]   # KeyError on unknown handle
            wav = np.asarray(wav, np.float32)
            if wav.shape != (self.hop,):
                raise ValueError(
                    f"hop for handle {handle} has shape {wav.shape}, "
                    f"expected ({self.hop},)")
            buf[slot] = wav
        x = torch.from_numpy(buf).to(device=self.device, dtype=self.dtype)
        carry, out = self._step(self._carry, x)
        if _signature(carry) != self._signature:
            raise ValueError("the streaming step changed its carry "
                             "structure; StreamingEngine requires a stable "
                             "carry")
        self._carry = carry
        out = out.float().cpu().numpy()
        return {h: out[self._slot_of[h]].copy() for h in hops}

    def flush(self, handle: int) -> np.ndarray:
        """Feed silence until the algorithmic delay is drained; returns the
        remaining `delay_samples` of output for this stream."""
        n_ticks = -(-self.delay_samples // self.hop)
        if n_ticks == 0:  # n_fft == hop: no algorithmic delay
            return np.zeros(0, np.float32)
        outs = [self.tick({handle: np.zeros(self.hop, np.float32)})[handle]
                for _ in range(n_ticks)]
        return np.concatenate(outs)[:self.delay_samples]

    def run_stream(self, handle: int, wav: np.ndarray) -> np.ndarray:
        """Stream a whole utterance through one handle (other active streams
        receive silence during these ticks) and return the delay-compensated
        enhancement, the same length as `wav` (a trailing partial hop is
        zero-padded on input and trimmed on output)."""
        wav = np.asarray(wav, np.float32)
        n = len(wav)
        padded = np.pad(wav, (0, -n % self.hop))
        outs = [self.tick({handle: padded[i:i + self.hop]})[handle]
                for i in range(0, len(padded), self.hop)]
        outs.append(self.flush(handle))
        return np.concatenate(outs)[self.delay_samples:
                                    self.delay_samples + n]


__all__ = ["StreamingEngine"]
