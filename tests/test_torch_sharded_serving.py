"""The port's StreamingEngine with its slots split over several devices.

The JAX engine at devices=4 shards the slots over 4 of the 8 virtual CPU
devices that tests/conftest.py forces; the port's engine takes the device
list ["cpu"] * 4 (four shards, each its own carry, plan and step on the
CPU). The same streams, joins, leaves and slot reuse go through both:
the port's sharded engine equals JAX's sharded one at 1e-4 (float32, as
tests/test_torch_serving.py holds the one-device engines) and the port's
one-device engine at 1e-6 (each shard runs the same per-row arithmetic at
a quarter of the batch). The errors are JAX's: a capacity that does not
divide over the devices, more cards than exist, and a fused kernel that
cannot take one shard's batch.
"""
import numpy as np
import pytest
import jax
import torch

from fastenhancer_tpu.models.fastenhancer.default import Model as JModel
from fastenhancer_tpu.serving import StreamingEngine as JEngine
from fastenhancer_tpu_torch.models.fastenhancer.default import Model as TModel
from fastenhancer_tpu_torch.serving import StreamingEngine
from fastenhancer_tpu_torch.utils import tree_leaves

from _torch_parity import (TINY_KWARGS, perturb_bn_stats, port_variables,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

HOP = TINY_KWARGS["hop_size"]
CPUS = ["cpu"] * 4
DPRNN_KWARGS = dict(
    {k: v for k, v in TINY_KWARGS.items() if k != "rnnformer_kwargs"},
    dprnn_kwargs=dict(num_blocks=1, channels=8, freq=8, channels_frnn=4))


def _wav(n_hops, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, n_hops * HOP).astype(np.float32)


def _setup(fused):
    jm, tm = JModel(**TINY_KWARGS), TModel(**TINY_KWARGS)
    jv = perturb_bn_stats(jm.init(jax.random.PRNGKey(0)), 0)
    if fused:
        jv = jm.fold(jax.tree.map(jax.numpy.asarray, jv))
    return jm, jv, tm, port_variables(jv)


def _choreography(engine):
    """Streams on every shard of a capacity-8 engine over 4 devices (two
    slots a shard): five join, two leave, two join again into the freed
    slots of shards 0 and 2, and streams past their end are fed silence.
    Returns every
    tick's outputs stacked by handle order."""
    wavs = [_wav(9, 20 + i) for i in range(7)]
    handles = [engine.open_stream() for _ in range(5)]
    pos = {h: 0 for h in handles}
    src = dict(zip(handles, wavs))
    outs = []

    def tick(active):
        hops = {}
        for h in active:
            w = src[h]
            i = pos[h]
            hops[h] = w[i * HOP:(i + 1) * HOP] if (i + 1) * HOP <= len(w) \
                else np.zeros(HOP, np.float32)
            pos[h] = i + 1
        o = engine.tick(hops)
        outs.append(np.stack([o[h] for h in active]))

    for _ in range(3):
        tick(handles)
    engine.close_stream(handles[0])   # slot 0, shard 0
    engine.close_stream(handles[4])   # slot 4, shard 2
    tick(handles[1:4])
    late = [engine.open_stream(), engine.open_stream()]
    assert sorted(engine._slot_of[h] for h in late) == [0, 4]
    for h, w in zip(late, wavs[5:]):
        src[h], pos[h] = w, 0
    active = handles[1:4] + late
    for _ in range(5):
        tick(active)
    return np.concatenate(outs)


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_engine_matches_jax_and_one_device(fused):
    jm, jv, tm, tv = _setup(fused)
    got = _choreography(StreamingEngine(tm, tv, capacity=8, fused=fused,
                                        devices=CPUS))
    want_j = _choreography(JEngine(jm, jv, capacity=8, fused=fused,
                                   devices=4))
    np.testing.assert_allclose(got, want_j, atol=1e-4)
    one = _choreography(StreamingEngine(tm, tv, capacity=8, fused=fused,
                                        device="cpu"))
    np.testing.assert_allclose(got, one, atol=1e-6)


def test_sharded_engine_reset_touches_the_owning_shard_only():
    _, _, tm, tv = _setup(fused=True)
    engine = StreamingEngine(tm, tv, capacity=8, fused=True, devices=CPUS)
    assert engine.per_shard == 2 and len(engine._shards) == 4
    handles = [engine.open_stream() for _ in range(8)]
    for i in range(2):   # every slot's carry moves off its fresh state
        engine.tick({h: _wav(1, 10 * h + i) for h in handles})
    before = [[t.clone() for t in tree_leaves(s.carry)]
              for s in engine._shards]
    engine.close_stream(5)   # slot 5: shard 2, its second slot
    engine.open_stream()
    for i, s in enumerate(engine._shards):
        after = tree_leaves(s.carry)
        same = all(torch.equal(a, b) for a, b in zip(after, before[i]))
        assert same == (i != 2), i


class _Aligned(TModel):
    """A model whose fused kernel takes batches of at least 4 (as the JAX
    package's sublane-aligned dprnn and bsrnn kernels), recording the
    batches the engine asks about."""

    asked = []

    def validate_fused_batch(self, batch, dtype):
        self.asked.append(batch)
        if batch < 4:
            raise ValueError(f"fused serving needs an aligned capacity; "
                             f"{batch} rows has none")


def test_sharded_engine_errors_match_jax(monkeypatch):
    jm, jv, tm, tv = _setup(fused=True)
    with pytest.raises(ValueError, match="divide evenly"):
        StreamingEngine(tm, tv, capacity=5, devices=CPUS)
    with pytest.raises(ValueError):
        JEngine(jm, jv, capacity=5, devices=4)
    # more cards than exist (none on this machine)
    with pytest.raises(ValueError, match="devices are available"):
        StreamingEngine(tm, tv, capacity=4, devices=2)
    with pytest.raises(ValueError, match="devices are available"):
        JEngine(jm, jv, capacity=len(jax.devices()) * 4,
                devices=len(jax.devices()) * 2)
    with pytest.raises(TypeError):
        StreamingEngine(tm, tv, capacity=4, device="cpu", devices=CPUS)

    # the kernel's batch is checked per shard: 4 over 2 devices is 2 rows
    model = _Aligned(**TINY_KWARGS)
    with pytest.raises(ValueError, match="aligned capacity"):
        StreamingEngine(model, tv, capacity=4, fused=True,
                        devices=["cpu"] * 2)
    StreamingEngine(model, tv, capacity=4, fused=True, device="cpu")
    StreamingEngine(model, tv, capacity=8, fused=True, devices=["cpu"] * 2)
    assert _Aligned.asked == [2, 4, 4]
    # JAX's engine refuses the same shard batch (its dprnn kernel's check,
    # made to refuse fewer than 4 rows as above)
    import fastenhancer_tpu.ops.dprnn_stack as mod
    from fastenhancer_tpu.models import get_model

    dprnn = get_model("fastenhancer.dprnn", **DPRNN_KWARGS)
    folded = dprnn.fold(dprnn.init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(mod, "supports_batch", lambda b, *a, **k: b >= 4)
    with pytest.raises(ValueError, match="aligned capacity"):
        JEngine(dprnn, folded, capacity=4, fused=True, devices=2)
    JEngine(dprnn, folded, capacity=4, fused=True)
