"""Train mode of FastEnhancer's variants against the JAX package: the
dptransformer, dprnn, ln, time_kernel and noncausal models at tiny widths,
each with its recipe's train section (configs/ablation/{dpt,dprnn,ln,
time_kernel}_b.yaml; configs/fastenhancer_dns/huge_noncausal.yaml for the
noncausal model, whose own recipes are DNS ones): forward(train=True) with
a zero-padded row masked out, the gradients of the weighted loss, two
float32 optimizer steps through make_train_step, the optimizer on JAX's
gradients, the reference names and optimizer groups, and a spy showing
that no train step runs #5 (its plain version stands for the kernel on the
CPU).
Tolerances: tests/_torch_train_parity.py."""
import pytest

from _torch_parity import (TINY_KWARGS, real_triton_only,  # noqa: F401
                           torch_one_thread)
import _torch_train_parity as tp

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

# the share of param elements that assert_steps_match holds to its wide
# bound over the two steps: measured 0.607 (dpt: AdamP widens whole
# leaves), 0.0121 (dprnn), 0.191 (ln), 0.0118 (time_kernel), 0.0525
# (noncausal)
WIDE_SHARE = {"dpt": 0.75, "dprnn": 0.03, "ln": 0.3, "time_kernel": 0.03,
              "noncausal": 0.1}
HOP = 64
SMALL = dict(channels=12, stride=4, n_fft=128, hop_size=HOP, win_size=128,
             window="hann", weight_norm=True, pre_post_init="linear_fixed")
BLOCKS = dict(num_blocks=2, channels=8, freq=8)
# name -> (model, kwargs, recipe, case options, has a GRU)
FAMILIES = {
    "dpt": ("fastenhancer.dptransformer", dict(
        SMALL, kernel_size=[4, 3], dpt_kwargs=dict(
            BLOCKS, num_heads=2, lookbehind=5, pre_norm=True,
            attn_bias=True, eps=1e-5)),
        "ablation/dpt_b.yaml", {}, False),
    "dprnn": ("fastenhancer.dprnn", dict(
        SMALL, kernel_size=[4, 3], dprnn_kwargs=dict(
            BLOCKS, channels_frnn=4, pre_norm=True)),
        "ablation/dprnn_b.yaml", {}, True),
    "ln": ("fastenhancer.ln", dict(TINY_KWARGS), "ablation/ln_b.yaml",
           {"norms": True}, True),
    "time_kernel": ("fastenhancer.time_kernel", dict(
        SMALL, kernel_size_freq=[4, 3], kernel_size_time=3,
        rnnformer_kwargs=dict(BLOCKS, num_heads=2)),
        "ablation/time_kernel_b.yaml", {}, True),
    "noncausal": ("fastenhancer.noncausal", dict(
        TINY_KWARGS, rnnformer_kwargs=dict(
            TINY_KWARGS["rnnformer_kwargs"], pre_norm=True)),
        "fastenhancer_dns/huge_noncausal.yaml", {}, True),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def case(request):
    model, kwargs, config, opts, has_gru = FAMILIES[request.param]
    c = tp.build_case(model, kwargs, config, **opts)
    c["name"] = request.param
    c["has_gru"] = has_gru
    c["jax_steps"] = tp.run_jax_steps(c["jm"], c["jv"], c["hp"], c["batch"])
    return c


def test_train_forward_matches_jax(case):
    tp.check_train_forward(case["jm"], case["jv"], case["tm"], case["tv"],
                           case["batch"])


def test_gradients_match_jax(case):
    total, grads = tp.port_grads(case["tm"], case["tv"], case["hp"],
                                 case["batch"])
    _, jmetrics, jgrads, _, _ = case["jax_steps"][0]
    assert abs(total / jmetrics["loss/total"] - 1) < 1e-5
    assert "loss/pesq" in jmetrics or "pesq" not in case["hp"]["losses"]
    tp.assert_grads_close(grads, jgrads)


def test_two_steps_match_jax(case):
    steps = tp.run_port_steps(case["tm"], case["tv"], case["hp"],
                              case["batch"], resync=case["jax_steps"])
    wide, total = tp.assert_steps_match(
        steps, case["jax_steps"], projected=case["hp"]["optimizer"] == "AdamP")
    assert wide <= WIDE_SHARE[case["name"]] * total, (wide, total)


def test_optimizer_on_jax_gradients_matches_jax(case):
    tp.check_optimizer_on_jax_grads(case)


def test_names_and_optimizer_groups_match_jax(case):
    tp.check_names_and_groups(case)


def test_no_kernel_in_a_train_step(case, monkeypatch):
    tp.check_no_kernel_in_train(case, monkeypatch, case["has_gru"])


def test_bf16_step_holds_to_jax_float32(case):
    tp.check_bf16_step(case)
