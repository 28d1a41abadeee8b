"""The dpt-stack op (fastenhancer_tpu_torch/ops/dpt_stack.py) and the fused
dpt streaming path.

The plan and the plain version against the JAX package's Pallas kernel
(interpret mode, as tests/test_ops_pallas.py runs it), converting between
its channel-major cache [NB, L, C, B*Fp] and the port's [NB, B, L, F, C];
the fused stream against the unfused one while the slot pointer wraps; the
zeroed-slot property the serving engine relies on; and the one deliberate
divergence, the frequency softmax's per-head max. The CUDA kernel itself is
tested on the card by tests/test_torch_cuda_kernels.py.

Tolerances: float32 1e-5 absolute (sums of at most a few hundred terms of
order 1); bfloat16 vs the Pallas kernel 2^-5 of the largest magnitude (a
few bf16 ulps: a sum on a rounding boundary can round either way).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fastenhancer_tpu.models.fastenhancer.dptransformer import Model as JModel
from fastenhancer_tpu.ops import dpt_stack as jdpt
from fastenhancer_tpu.ops.rnnformer_stack import pad_freq
from fastenhancer_tpu_torch.models.fastenhancer.dptransformer import (
    Model as TModel)
from fastenhancer_tpu_torch.ops import dpt_stack as tdpt

from _torch_parity import (as_np, perturb_bn_stats, port_variables,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ATOL = 1e-5
LB = 5


def _models(freq=8, pre_norm=False):
    kw = dict(channels=12, kernel_size=[4, 3], stride=4,
              dpt_kwargs=dict(num_blocks=2, channels=8, freq=freq,
                              num_heads=2, lookbehind=LB,
                              positional_embedding="train",
                              pre_norm=pre_norm, eps=1e-5),
              n_fft=128, hop_size=64, win_size=128, window="hann",
              weight_norm=True, pre_post_init="linear_fixed",
              stft_method="matmul")
    return JModel(**kw), TModel(**kw)


def _folded(jm, seed):
    jv = jax.tree.map(jnp.asarray,
                      perturb_bn_stats(jm.init(jax.random.PRNGKey(seed)),
                                       seed))
    jf = jm.fold(jv)
    return jf, port_variables(jf)


def _jax_plan(jm, jf, dtype=None):
    cfg = jm.dpt
    return jdpt.plan_dpt_stack(jf["params"]["rf_blocks"],
                               jf["params"]["time_pe"]["weight"], cfg.freq,
                               cfg.num_heads, cfg.lookbehind, dtype=dtype)


def _inputs(tm, b, seed, written):
    """x [B, F, C] and a cache [NB, B, L, F, C] whose slots >= written are
    zero (never written)."""
    rng = np.random.default_rng(seed)
    cfg = tm.dpt
    x = rng.standard_normal((b, cfg.freq, cfg.channels)).astype(np.float32)
    shape = tdpt.cache_shape(cfg.num_blocks, b, LB, cfg.freq, cfg.channels)
    kc = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    vc = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    kc[:, :, written:] = 0
    vc[:, :, written:] = 0
    return x, kc, vc


def _to_jax_cache(c, fp):
    """[NB, B, L, F, C] -> the Pallas kernel's [NB, L, C, B*Fp] (rows
    b-major, padded frequency rows zero)."""
    nb, b, lb, f, ch = c.shape
    out = np.zeros((nb, lb, ch, b, fp), c.dtype)
    out[..., :f] = c.transpose(0, 2, 4, 1, 3)
    return out.reshape(nb, lb, ch, b * fp)


def _from_jax_slot(k, b, f):
    """The Pallas kernel's k_new [NB, C, B*Fp] -> [NB, B, F, C]."""
    nb, ch, rows = k.shape
    return np.asarray(k, np.float32).reshape(nb, ch, b, rows // b)[
        ..., :f].transpose(0, 2, 3, 1)


def test_plan_matches_jax_plan():
    """The head-major q/k/v gathers of both attentions, the transposed fcs,
    pe and time_pe."""
    jm, tm = _models()
    jf, tf = _folded(jm, 0)
    jp, tp_ = _jax_plan(jm, jf), tm.build_stack_plan(tf)
    for o, name in enumerate("qkv"):
        # the time projections are stored untransposed by the Pallas plan
        np.testing.assert_array_equal(
            as_np(tp_["w_tqkv"][:, o]),
            np.asarray(jp[f"w_t{name}"]).transpose(0, 2, 1))
        np.testing.assert_array_equal(as_np(tp_["w_fqkv"][:, o]),
                                      np.asarray(jp[f"w_f{name}"]))
        for which in "tf":
            np.testing.assert_array_equal(
                as_np(tp_[f"b_{which}qkv"][:, o]),
                np.asarray(jp[f"b_{which}{name}"])[:, 0])
    for name in ("w_tfc", "w_ffc"):
        np.testing.assert_array_equal(as_np(tp_[name]), np.asarray(jp[name]))
    for name in ("b_tfc", "b_ffc"):
        np.testing.assert_array_equal(as_np(tp_[name]),
                                      np.asarray(jp[name])[:, 0])
    np.testing.assert_array_equal(as_np(tp_["pe"]), np.asarray(jp["pe"]))
    np.testing.assert_array_equal(as_np(tp_["time_pe"]),
                                  np.asarray(jp["time_pe"]))
    with pytest.raises(ValueError, match="fold"):
        tm.build_stack_plan(port_variables(jm.init(jax.random.PRNGKey(0))))


def test_slot_bias_matches_bias_lanes_for_ptr():
    rng = np.random.default_rng(1)
    pe = rng.standard_normal((2, LB + 1)).astype(np.float32)
    for ptr in range(2 * LB):
        want = np.asarray(jdpt.bias_lanes_for_ptr(jnp.asarray(pe),
                                                  jnp.int32(ptr), LB))
        got = tdpt.slot_bias(torch.tensor(pe),
                             torch.tensor(ptr % LB, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy().reshape(1, -1), want)


@pytest.mark.parametrize("freq,ptr,written", [
    (8, 0, LB), (8, 3, LB), (8, LB - 1, 2), (6, 2, 0)],
    ids=["ptr0", "ptr3", "about-to-wrap-unwritten", "F6-cold"])
def test_plain_stack_matches_pallas(freq, ptr, written):
    """F=6 is not a multiple of 8: the Pallas kernel pads it to 16; the
    port takes it as it is."""
    jm, tm = _models(freq)
    jf, tf = _folded(jm, 2)
    b = 3
    x, kc, vc = _inputs(tm, b, 2, written)
    fp = pad_freq(freq)
    bias = jdpt.bias_lanes_for_ptr(_jax_plan(jm, jf)["time_pe"],
                                   jnp.int32(ptr), LB)
    xj, kj, vj = jdpt.dpt_stack_step(
        _jax_plan(jm, jf), jnp.asarray(x), jnp.asarray(_to_jax_cache(kc, fp)),
        jnp.asarray(_to_jax_cache(vc, fp)), bias, tm.dpt.num_heads, LB,
        interpret=True)
    kc_t, vc_t = torch.tensor(kc), torch.tensor(vc)
    xt, pt = tdpt.dpt_stack_reference(tm.build_stack_plan(tf),
                                      torch.tensor(x), kc_t, vc_t,
                                      torch.tensor(ptr, dtype=torch.int32),
                                      tm.dpt.num_heads)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL)
    assert int(pt) == (ptr + 1) % LB
    for got, new, old in ((kc_t, kj, kc), (vc_t, vj, vc)):
        np.testing.assert_allclose(got[:, :, ptr].numpy(),
                                   _from_jax_slot(new, b, freq), atol=ATOL)
        others = [s for s in range(LB) if s != ptr]
        np.testing.assert_array_equal(got[:, :, others].numpy(),
                                      old[:, :, others])


def test_plain_stack_bf16_cast_points_match_pallas():
    jm, tm = _models()
    jf, tf = _folded(jm, 3)
    b, ptr = 4, 2
    x, kc, vc = _inputs(tm, b, 3, LB)
    jp = _jax_plan(jm, jf, dtype=jnp.bfloat16)
    bias = jdpt.bias_lanes_for_ptr(jp["time_pe"], jnp.int32(ptr), LB)
    xj, kj, _ = jdpt.dpt_stack_step(
        jp, jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(_to_jax_cache(kc, 8), jnp.bfloat16),
        jnp.asarray(_to_jax_cache(vc, 8), jnp.bfloat16), bias,
        tm.dpt.num_heads, LB, interpret=True)
    kc_t = torch.tensor(kc).bfloat16()
    xt, _ = tdpt.dpt_stack_reference(
        tm.build_stack_plan(tf, dtype=torch.bfloat16),
        torch.tensor(x).bfloat16(), kc_t, torch.tensor(vc).bfloat16(),
        torch.tensor(ptr, dtype=torch.int32), tm.dpt.num_heads)
    assert xt.dtype == torch.bfloat16
    for got, want in ((xt, np.asarray(xj, np.float32)),
                      (kc_t[:, :, ptr], _from_jax_slot(kj, b, 8))):
        np.testing.assert_allclose(as_np(got), want,
                                   atol=2.0 ** -5 * np.abs(want).max())


@pytest.mark.parametrize("pre_norm", [False, True])
def test_fused_stream_matches_unfused_while_the_pointer_wraps(pre_norm):
    """2L+3 frames: the cold start, then the pointer wraps twice. The fused
    stream against the port's unfused stream and JAX's fused stream."""
    jm, tm = _models(pre_norm=pre_norm)
    jf, tf = _folded(jm, 4)
    rng = np.random.default_rng(4)
    wav = (rng.standard_normal((3, 64 * (2 * LB + 3))) * 0.1).astype(
        np.float32)
    before = tdpt.dpt_stack_step.launches
    y_fused = tm.stream(tf, torch.tensor(wav),
                        fused_plan=tm.build_stack_plan(tf)).numpy()
    assert tdpt.dpt_stack_step.launches == before  # the CPU launches none
    y_plain = tm.stream(tf, torch.tensor(wav)).numpy()
    y_jax = np.asarray(jm.stream(jf, jnp.asarray(wav),
                                 fused_plan=jm.build_stack_plan(jf)))
    np.testing.assert_allclose(y_fused, y_plain, atol=ATOL)
    np.testing.assert_allclose(y_fused, y_jax, atol=ATOL)


def test_zeroed_cache_is_correct_at_any_pointer():
    """A stream that starts with a zeroed cache at pointer p gives the same
    output as one that starts at pointer 0: what lets the serving engine
    reset one slot while the shared pointer moves on."""
    jm, tm = _models()
    _, tf = _folded(jm, 5)
    plan = tm.build_stack_plan(tf)
    rng = np.random.default_rng(5)
    hops = torch.tensor((rng.standard_normal((2 * LB + 1, 2, 64)) * 0.1)
                        .astype(np.float32))
    outs = []
    for start in (0, 3, LB - 1):
        carry = tm.init_streaming_carry(2, torch.float32, "cpu", fused=True)
        carry["ptr"].fill_(start)
        ys = []
        for hop in hops:
            carry, y = tm.streaming_step_fused(tf, plan, carry, hop)
            ys.append(y)
        assert int(carry["ptr"]) == (start + len(hops)) % LB
        outs.append(torch.cat(ys, 1).numpy())
    for y in outs[1:]:
        np.testing.assert_allclose(y, outs[0], atol=ATOL)


def test_freq_softmax_per_head_max_diverges_from_pallas():
    """The deliberate divergence (ROADMAP queue 3): the Pallas kernel
    stabilises the frequency softmax with the max across heads, so a head
    whose logits sit far below another's underflows to 0. The port uses
    each head's own max and matches the XLA path (JAX's _block_apply),
    relative 1e-5; the Pallas kernel misses it by more than 1e-3 of the
    largest magnitude."""
    jm, tm = _models()
    jf = jm.fold(jm.init(jax.random.PRNGKey(7)))
    blocks = jf["params"]["rf_blocks"]
    c = jm.dpt.channels
    w = np.asarray(blocks[0]["freq_attn"]["qkv"]["weight"]).copy()
    w[:c // 2] *= 4000.0   # q rows of head 0 (per-head [q|k|v] layout)
    blocks[0]["freq_attn"]["qkv"]["weight"] = jnp.asarray(w)
    tf = port_variables(jf)
    b = 2
    rng = np.random.default_rng(7)
    x = rng.uniform(1.0, 2.0, (b, jm.dpt.freq, c)).astype(np.float32)
    shape = tdpt.cache_shape(jm.dpt.num_blocks, b, LB, jm.dpt.freq, c)
    xt, _ = tdpt.dpt_stack_step(
        tm.build_stack_plan(tf), torch.tensor(x), torch.zeros(shape),
        torch.zeros(shape), torch.zeros((), dtype=torch.int32),
        jm.dpt.num_heads)
    assert torch.isfinite(xt).all()
    # the XLA path, one frame from zero caches
    x_ref = jnp.asarray(x)[None]
    jm._pe_time = jf["params"]["time_pe"]["weight"]
    for bp, bs in zip(blocks, jf["stats"]["rf_blocks"]):
        carry = jm._block_carry_init(b, jnp.float32)
        x_ref, _, _ = jm._block_apply(bp, bs, x_ref, carry, train=False)
    del jm._pe_time
    want = np.asarray(x_ref[0])
    np.testing.assert_allclose(xt.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    bias = jdpt.bias_lanes_for_ptr(_jax_plan(jm, jf)["time_pe"], jnp.int32(0),
                                   LB)
    zeros = jnp.zeros((jm.dpt.num_blocks, LB, c, b * jm.dpt.freq))
    xj, _, _ = jdpt.dpt_stack_step(_jax_plan(jm, jf), jnp.asarray(x), zeros,
                                   zeros, bias, jm.dpt.num_heads, LB,
                                   interpret=True)
    assert np.abs(np.asarray(xj) - want).max() > 1e-3 * np.abs(want).max()


def test_wrapper_cpu_path_and_checks():
    """A CPU tensor takes the plain version and launches nothing; bad
    operands raise before anything runs; DPT T/B/S fit one thread block's
    shared memory."""
    jm, tm = _models()
    _, tf = _folded(jm, 8)
    plan = tm.build_stack_plan(tf)
    x, kc, vc = (torch.tensor(a) for a in _inputs(tm, 2, 8, LB))
    ptr = torch.tensor(1, dtype=torch.int32)
    before = tdpt.dpt_stack_step.launches
    kc2, vc2 = kc.clone(), vc.clone()
    kc3, vc3 = kc.clone(), vc.clone()
    got = tdpt.dpt_stack_step(plan, x, kc, vc, ptr, 2)
    want = tdpt.dpt_stack_reference(plan, x, kc2, vc2, ptr, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert tdpt.dpt_stack_step.launches == before
    # a pointer past L is taken mod L
    got = tdpt.dpt_stack_step(plan, x, kc3, vc3,
                              torch.tensor(LB + 1, dtype=torch.int32), 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(kc3, kc) and torch.equal(vc3, vc)
    with pytest.raises(ValueError, match="dtype|bfloat16"):
        tdpt.dpt_stack_step(plan, x, kc.bfloat16(), vc, ptr, 2)
    with pytest.raises(ValueError, match="int32"):
        tdpt.dpt_stack_step(plan, x, kc, vc, ptr.long(), 2)
    with pytest.raises(ValueError, match="shape"):
        tdpt.dpt_stack_step(plan, x, kc[:, :1], vc, ptr, 2)
    with pytest.raises(ValueError, match="H="):
        tdpt.dpt_stack_step(plan, x, kc, vc, ptr, 3)
    for f, c in ((16, 20), (24, 36), (36, 48)):
        assert tdpt.smem_bytes(f, c, 4, 31) <= tdpt.MAX_SMEM_BYTES


# --- the kernel's forms (no JAX needed below) --------------------------------

BF16 = torch.bfloat16
# the H100's shared memory a SM (228 KB), and what it reserves a block
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024


@pytest.mark.parametrize("name,f,c", [("DPT-T", 16, 20), ("DPT-B", 24, 36),
                                      ("DPT-S", 36, 48)])
def test_dpt_configs_run_the_tc_form_in_bf16(name, f, c):
    assert tdpt.kernel_form(f, c, 4, 31, BF16) == "tc", name
    assert tdpt.kernel_form(f, c, 4, 31, torch.float32) == "scalar", name


@pytest.mark.parametrize("f,c,lb", [
    (13, 12, 31),    # the card tests' odd shape: a slot is 312 bytes
    (7, 9, 31),      # 126 bytes
    (5, 10, 4),      # 100 bytes
    (8, 80, 31),     # C / H = 20: q outgrows a thread's registers
    (72, 16, 31),    # H F = 288 rows: more than one a thread
    (48, 48, 31),    # F C = 2304: more than 4 channel pairs a thread
    (64, 64, 255)])  # the tiles, logits and ring outgrow shared memory
def test_other_shapes_run_the_scalar_form(f, c, lb):
    assert tdpt.kernel_form(f, c, 4 if c % 4 == 0 else 1, lb,
                            BF16) == "scalar"


@pytest.mark.parametrize("f,c,lb,want", [(24, 36, 31, 9), (16, 20, 31, 25),
                                         (36, 48, 31, 4), (8, 8, 31, 31),
                                         (8, 16, 5, 5), (128, 64, 31, 1)])
def test_tc_chunk_slots(f, c, lb, want):
    assert tdpt.tc_chunk_slots(f, c, lb) == want
    assert want * 2 * f * c <= max(tdpt.TC_CHUNK_BYTES, 2 * f * c)


def test_tc_smem_bytes_at_dpt_b():
    # head; x and two free [F, ld(C)] tiles, head-padded q, k, v [F, ld(64)],
    # probabilities [H, F, ld(F)]; float32 logits [32 keys, 96 + 8] and the
    # slot bias [H, 32]; 4 ring chunks of 9 slots; two slots, each the qkv
    # stage in padded rows
    tiles = 3 * 24 * 40 + 3 * 24 * 72 + 4 * 24 * 24
    floats = 32 * 104 + 4 * 32
    want = 48 + 2 * (tiles + 2 * floats + 4 * 9 * 24 * 36
                     + 2 * (3 * 36 * 40 + 112))
    assert tdpt.tc_smem_bytes(24, 36, 4, 31) == want
    # two blocks a SM: all 256 streams resident in one wave on 132 SMs
    assert 2 * (want + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES


def test_tc_shared_memory_fits_where_the_rule_says_tc():
    for f in (1, 8, 16, 24, 36, 64):
        for c in (8, 16, 20, 36, 48, 64):
            for lb in (1, 7, 31, 64):
                if tdpt.kernel_form(f, c, 4, lb, BF16) == "tc":
                    assert (tdpt.tc_smem_bytes(f, c, 4, lb)
                            <= tdpt.MAX_SMEM_BYTES)
                    assert (2 * f * c) % 16 == 0


def _form_case(b, f=8, c=8, nb=2, lb=5, dtype=BF16):
    g = torch.Generator().manual_seed(b)
    plan = {k: ((torch.rand(s, generator=g) * 2 - 1) / c ** 0.5).to(dtype)
            for k, s in tdpt.plan_shapes(nb, f, c, 4, lb).items()}
    x = torch.randn(b, f, c, generator=g).to(dtype)
    shape = tdpt.cache_shape(nb, b, lb, f, c)
    kc, vc = ((torch.randn(shape, generator=g) * 0.5).to(dtype)
              for _ in range(2))
    return plan, x, kc, vc, torch.tensor(3, dtype=torch.int32)


def test_launch_tc_refuses_what_the_form_does_not_take():
    plan, x, kc, vc, p = _form_case(2, dtype=torch.float32)
    with pytest.raises(ValueError, match="tensor-core form does not take"):
        tdpt.launch_tc(plan, x, kc, vc, p, 4)
    plan, x, kc, vc, p = _form_case(2, f=13, c=12)
    with pytest.raises(ValueError, match="tensor-core form does not take"):
        tdpt.launch_tc(plan, x, kc, vc, p, 4)
    plan, x, kc, vc, p = _form_case(2)
    flat = torch.empty(kc.numel() + 1, dtype=BF16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tdpt.launch_tc(plan, x, flat[1:].view(kc.shape), vc, p, 4)
    # everything right, but the kernel has no CPU mode
    with pytest.raises(ValueError, match="CUDA device"):
        tdpt.launch_tc(plan, x, kc, vc, p, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        tdpt.launch_scalar(plan, x, kc, vc, p, 4)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_cpu_step_is_the_plain_version_and_counts_no_launch(dtype):
    plan, x, kc, vc, p = _form_case(3, dtype=dtype)
    kr, vr = kc.clone(), vc.clone()
    before = (tdpt.dpt_stack_step.launches, tdpt.dpt_stack_step.tc_launches)
    got = tdpt.dpt_stack_step(plan, x, kc, vc, p, 4)
    want = tdpt.dpt_stack_reference(plan, x, kr, vr, p, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(kc, kr) and torch.equal(vc, vr)
    assert (tdpt.dpt_stack_step.launches,
            tdpt.dpt_stack_step.tc_launches) == before
