"""Train mode of the FSPEN and LiSenNet baselines against the JAX package
at tiny widths, each with its recipe's train section (configs/others/
{fspen,lisennet}.yaml): forward(train=True) with a zero-padded row masked
out (FSPEN's train-mode BN; LiSenNet has no batch statistics), the
gradients of the weighted loss, two float32 optimizer steps through
make_train_step, the optimizer on JAX's gradients, the reference names
and optimizer groups, one bfloat16 step held to JAX's float32 step, and a
spy showing that no train step runs #5. FSPEN's last ConvTranspose and mask
and LiSenNet's phase features run in float32 in every mode (ROADMAP queue
3), so in bfloat16 the port is held to JAX's float32 step, as every
family's bf16 step is (tests/_torch_train_parity.py). LiSenNet's audio
has silent edges (its phase features sit on their branch cut on the
offline STFT's edge frames otherwise) and both use the matmul STFT, as
tests/test_torch_baselines.py. Tolerances: tests/_torch_train_parity.py.
BSRNN's are tests/test_torch_train_bsrnn.py."""
import pytest

from fastenhancer_tpu_torch.models.lisennet import Model as LiSenNet

from _torch_parity import (real_triton_only,  # noqa: F401
                           torch_one_thread)
import _torch_train_parity as tp

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

# the share of param elements that assert_steps_match holds to its wide
# bound over the two steps: measured 0.173 (FSPEN: AdamP widens whole
# leaves), 0.00097 (LiSenNet, AdamW)
WIDE_SHARE = {"fspen": 0.25, "lisennet": 0.005}
FAMILIES = {
    "fspen": ("fspen", dict(channels=[4, 8, 16], stft_method="matmul",
                            dpe_kwargs=dict(num_blocks=1, channels=8,
                                            groups=2)),
              "others/fspen.yaml", {}),
    "lisennet": ("lisennet", dict(num_channels=8, n_blocks=1,
                                  stft_method="matmul"),
                 "others/lisennet.yaml", {"silent_edges": 257}),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def case(request):
    model, kwargs, config, opts = FAMILIES[request.param]
    c = tp.build_case(model, kwargs, config, **opts)
    c["name"] = request.param
    c["jax_steps"] = tp.run_jax_steps(c["jm"], c["jv"], c["hp"], c["batch"])
    return c


def test_train_forward_matches_jax(case):
    """LiSenNet's spec to 2e-5: its IFD feature takes sin and cos of up to
    ~804 rad, where a float32 ulp is 6e-5 rad (2 of 20046 values of this
    batch are 1.2e-5 off)."""
    spec_atol = 2e-5 if isinstance(case["tm"], LiSenNet) else 1e-5
    tp.check_train_forward(case["jm"], case["jv"], case["tm"], case["tv"],
                           case["batch"], spec_atol=spec_atol)


def test_gradients_match_jax(case):
    total, grads = tp.port_grads(case["tm"], case["tv"], case["hp"],
                                 case["batch"])
    _, jmetrics, jgrads, _, _ = case["jax_steps"][0]
    assert abs(total / jmetrics["loss/total"] - 1) < 1e-5
    assert "loss/pesq" in jmetrics
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


def test_bf16_step_holds_to_jax_float32(case):
    tp.check_bf16_step(case)


def test_no_kernel_in_a_train_step(case, monkeypatch):
    tp.check_no_kernel_in_train(case, monkeypatch, has_gru=True)
