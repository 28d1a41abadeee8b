"""Train mode of the BSRNN baseline against the JAX package at a tiny width
(C = 8, one layer; the 31 bands are the recipe's), with the recipe's train
section (configs/others/bsrnn_s.yaml, AdamW): forward(train=True) with a
zero-padded row masked out (the grouped band split and mask decoder,
every BN in train mode with each band's own statistics), the gradients of
the weighted loss, two float32 steps, the optimizer on JAX's gradients,
the reference names and optimizer groups, one bfloat16 step held to JAX's
float32 one, and a spy showing that no train step runs #5. Apart from
tests/test_torch_train_baselines.py because JAX's train step of 31 bands takes ~40 s to compile here. The
variables come from the port's init (JAX's init of 31 bands takes ~40 s
more). Tolerances: tests/_torch_train_parity.py."""
import pytest

from _torch_parity import (real_triton_only,  # noqa: F401
                           torch_one_thread)
import _torch_train_parity as tp

pytestmark = pytest.mark.usefixtures("real_triton_only", "torch_one_thread")

# the share of param elements that assert_steps_match holds to its wide
# bound over the two steps: measured 0.00025 (AdamW)
WIDE_SHARE = 0.002


@pytest.fixture(scope="module")
def case():
    c = tp.build_case("bsrnn", dict(num_channels=8, num_layers=1,
                                    stft_method="matmul"),
                      "others/bsrnn_s.yaml", frames=8)
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
    assert "loss/pesq" in jmetrics
    tp.assert_grads_close(grads, jgrads)


def test_two_steps_match_jax(case):
    steps = tp.run_port_steps(case["tm"], case["tv"], case["hp"],
                              case["batch"], resync=case["jax_steps"])
    wide, total = tp.assert_steps_match(steps, case["jax_steps"],
                                        projected=False)
    assert wide <= WIDE_SHARE * total, (wide, total)


def test_optimizer_on_jax_gradients_matches_jax(case):
    tp.check_optimizer_on_jax_grads(case)


def test_names_and_optimizer_groups_match_jax(case):
    assert tp.check_names_and_groups(case) == [516]


def test_bf16_step_holds_to_jax_float32(case):
    tp.check_bf16_step(case)


def test_no_kernel_in_a_train_step(case, monkeypatch):
    """BSRNN's offline forward has no GRU: nothing calls #5 in either
    mode (its stream runs kernel #3)."""
    tp.check_no_kernel_in_train(case, monkeypatch, has_gru=False)
