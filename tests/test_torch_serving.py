"""PyTorch port of serving.py (StreamingEngine, one device).

The property that matters: a stream served through a busy engine, with
other streams joining, leaving and reusing slots, gives the output of its
isolated `Model.stream` run. Tolerance 1e-5 (float32; the same arithmetic
at another batch size). The JAX engine on the same schedule and weights is
the parity check, at 1e-4 (float32 stream outputs).
"""
import numpy as np
import pytest
import jax
import torch

from fastenhancer_tpu.models.fastenhancer.default import Model as JModel
from fastenhancer_tpu.serving import StreamingEngine as JEngine
from fastenhancer_tpu_torch.models.fastenhancer.default import Model as TModel
from fastenhancer_tpu_torch.serving import StreamingEngine
from fastenhancer_tpu_torch.utils import cast_floating

from _torch_parity import TINY_KWARGS, perturb_bn_stats, port_variables

HOP = TINY_KWARGS["hop_size"]


def _wav(n_hops, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, n_hops * HOP).astype(np.float32)


def _setup(fused):
    jm, tm = JModel(**TINY_KWARGS), TModel(**TINY_KWARGS)
    jv = perturb_bn_stats(jm.init(jax.random.PRNGKey(0)), 0)
    if fused:
        jv = jm.fold(jax.tree.map(jax.numpy.asarray, jv))
    return jm, jv, tm, port_variables(jv)


def _isolated(model, variables, wav, plan=None):
    """Delay-compensated single-stream `stream()` run, aligned with
    StreamingEngine.run_stream."""
    delay = model.stft_cfg.n_fft - HOP
    pad = -len(wav) % HOP + -(-delay // HOP) * HOP
    padded = np.concatenate([wav, np.zeros(pad, np.float32)])
    out = model.stream(variables, torch.tensor(padded[None]),
                       fused_plan=plan)[0].numpy()
    return out[delay:delay + len(wav)]


def _schedule(engine):
    """a and b together, b leaves, c joins b's slot, a finishes alone, then
    both drain. Returns the delay-compensated outputs."""
    wav = {"a": _wav(8, 1), "b": _wav(6, 2), "c": _wav(5, 3)}
    outs = {k: [] for k in wav}
    ha, hb = engine.open_stream(), engine.open_stream()
    for i in range(2):
        o = engine.tick({ha: wav["a"][i * HOP:(i + 1) * HOP],
                         hb: wav["b"][i * HOP:(i + 1) * HOP]})
        outs["a"].append(o[ha])
        outs["b"].append(o[hb])
    engine.close_stream(hb)
    hc = engine.open_stream()
    assert engine._slot_of[hc] == 1  # really reusing the freed slot
    for i in range(5):
        o = engine.tick({ha: wav["a"][(2 + i) * HOP:(3 + i) * HOP],
                         hc: wav["c"][i * HOP:(i + 1) * HOP]})
        outs["a"].append(o[ha])
        outs["c"].append(o[hc])
    # a's last hop is c's first drain tick: every active stream advances on
    # every tick, so both tails are collected from the same ticks
    zeros = np.zeros(HOP, np.float32)
    for hop_a in [wav["a"][7 * HOP:]] + [zeros] * (-(-engine.delay_samples
                                                     // HOP)):
        o = engine.tick({ha: hop_a, hc: zeros})
        outs["a"].append(o[ha])
        outs["c"].append(o[hc])
    engine.close_stream(ha)
    engine.close_stream(hc)
    assert engine.active == 0
    delay = engine.delay_samples
    got = {k: np.concatenate(v)[delay:delay + len(wav[k])]
           for k, v in outs.items()}
    return wav, got


@pytest.mark.parametrize("fused", [False, True])
def test_slot_isolation_and_reuse(fused):
    _, _, tm, tv = _setup(fused)
    engine = StreamingEngine(tm, tv, capacity=3, fused=fused, device="cpu")
    wav, got = _schedule(engine)
    plan = tm.build_stack_plan(tv) if fused else None
    for k in got:  # b never drained: its output is a prefix
        want = _isolated(tm, tv, wav[k], plan)[:len(got[k])]
        np.testing.assert_allclose(got[k], want, atol=1e-5, err_msg=k)
    h = engine.open_stream()
    y = engine.run_stream(h, wav["b"][:5 * HOP + 7])
    np.testing.assert_allclose(y, _isolated(tm, tv, wav["b"][:5 * HOP + 7],
                                            plan), atol=1e-5)


def test_engine_matches_jax_engine():
    """The fused engine over the same schedule and weights as the JAX
    package's fused engine."""
    jm, jv, tm, tv = _setup(fused=True)
    _, got_t = _schedule(StreamingEngine(tm, tv, capacity=3, fused=True,
                                         device="cpu"))
    _, got_j = _schedule(JEngine(jm, jv, capacity=3, fused=True))
    for k in got_j:
        np.testing.assert_allclose(got_t[k], got_j[k], atol=1e-4, err_msg=k)


def test_engine_contracts():
    _, _, tm, tv = _setup(fused=True)
    with pytest.raises(ValueError, match="capacity"):
        StreamingEngine(tm, tv, capacity=1, device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        StreamingEngine(tm, tv, capacity=2, dtype=torch.bfloat16,
                        device="cpu")
    engine = StreamingEngine(tm, cast_floating(tv, torch.bfloat16),
                             capacity=2, dtype=torch.bfloat16, fused=True,
                             device="cpu")
    h = engine.open_stream()
    out = engine.tick({h: _wav(1, 4)})[h]
    assert out.dtype == np.float32 and out.shape == (HOP,)
    assert np.isfinite(out).all()
    with pytest.raises(ValueError, match="shape"):
        engine.tick({h: np.zeros(HOP + 1, np.float32)})
    engine.open_stream()
    with pytest.raises(RuntimeError, match="full"):
        engine.open_stream()
    engine.close_stream(h)
    with pytest.raises(KeyError):
        engine.tick({h: _wav(1, 5)})
    assert engine.active == 1
