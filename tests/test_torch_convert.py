"""The port's checkpoint converter (utils/convert.py) against the JAX
package's, for all ten model names at tiny widths.

A seeded variables tree is written as the reference PyTorch state dict by
`tests/_torch_reference_sd.py` (the inverse of the converters' key map)
and read back by both converters: the two trees have the same paths and
bit-equal leaves, and both give back the tree that was written. The tree
is the port's init (numpy leaves), whose paths the per-family tests hold
to JAX's init: JAX's eager init of FSPEN and LiSenNet alone takes 14-19 s
on a CPU.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (flatten_paths, to_np_tree,
                           torch_one_thread)  # noqa: F401
from _torch_reference_sd import reference_checkpoint, reference_state_dict
from fastenhancer_tpu.models import get_model as jax_get_model
from fastenhancer_tpu.utils import convert_checkpoint as jax_convert
from fastenhancer_tpu_torch.models import get_model
from fastenhancer_tpu_torch.utils import convert_checkpoint

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CPU = torch.device("cpu")
SMALL = dict(channels=12, stride=4, n_fft=128, hop_size=64, win_size=128,
             window="hann", weight_norm=True, pre_post_init="linear_fixed")
BLOCKS = dict(num_blocks=2, channels=8, freq=8)
RF = dict(BLOCKS, num_heads=2, positional_embedding="train")
# case -> (model name, model_kwargs)
CASES = {
    "default": ("fastenhancer.default",
                dict(SMALL, kernel_size=[4, 3], rnnformer_kwargs=RF)),
    "default-plain-weights": ("fastenhancer.default", dict(
        SMALL, kernel_size=[4, 3], weight_norm=False,
        rnnformer_kwargs=dict(RF, attn_bias=True))),
    "conv_stft": ("fastenhancer.conv_stft",
                  dict(SMALL, kernel_size=[4, 3], rnnformer_kwargs=RF)),
    "noncausal": ("fastenhancer.noncausal", dict(
        SMALL, kernel_size=[4, 3], rnnformer_kwargs=dict(RF,
                                                         pre_norm=True))),
    "ln": ("fastenhancer.ln", dict(SMALL, kernel_size=[4, 3],
                                   rnnformer_kwargs=RF)),
    "time_kernel": ("fastenhancer.time_kernel", dict(
        SMALL, kernel_size_freq=[4, 3], kernel_size_time=3,
        rnnformer_kwargs=RF)),
    "dprnn": ("fastenhancer.dprnn", dict(
        SMALL, kernel_size=[4, 3], dprnn_kwargs=dict(
            BLOCKS, channels_frnn=4, pre_norm=True))),
    "dptransformer": ("fastenhancer.dptransformer", dict(
        SMALL, kernel_size=[4, 3], dpt_kwargs=dict(
            BLOCKS, num_heads=2, lookbehind=5, pre_norm=True,
            attn_bias=True))),
    "bsrnn": ("bsrnn", dict(num_channels=8, num_layers=1)),
    "bsrnn-no-affine-no-bias": ("bsrnn", dict(num_channels=8, num_layers=1,
                                              affine=False, bias=False)),
    "fspen": ("fspen", dict(channels=[4, 8, 16], dpe_kwargs=dict(
        num_blocks=1, channels=8, groups=2))),
    "lisennet": ("lisennet", dict(num_channels=8, n_blocks=1)),
}


@functools.lru_cache(maxsize=None)
def _init(case):
    """The case's seeded variables, numpy leaves."""
    name, kwargs = CASES[case]
    model = get_model(name, **kwargs)
    return to_np_tree(model.init(torch.Generator().manual_seed(7), "cpu"))


def _leaves(tree):
    """{path: numpy leaf} without the None entries."""
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_paths(tree).items() if v is not None}


def test_every_model_name_has_a_case():
    from fastenhancer_tpu_torch.models import _MODELS

    assert {name for name, _ in CASES.values()} == set(_MODELS)


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_jax_and_gives_back_the_tree(case):
    name, kwargs = CASES[case]
    tree = _init(case)
    ckpt = reference_checkpoint(tree, name)
    assert all(k.startswith("module.") for k in ckpt["model"])
    sd = ckpt["model"]
    if name.startswith("fastenhancer.") and kwargs["weight_norm"]:
        assert any(".parametrizations.weight" in k for k in sd)
    else:
        assert not any(".parametrizations." in k for k in sd)
    want = flatten_paths(to_np_tree(jax_convert(ckpt, name, kwargs)))
    out = convert_checkpoint(ckpt, name, kwargs, device=CPU)
    got = flatten_paths(out)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        g = got[k]
        assert isinstance(g, torch.Tensor) and g.device == CPU, k
        assert g.dtype == torch.float32 and w.dtype == np.float32, k
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), k
    # both give back the tree that was written (the ln converter adds
    # decoder bn1/bn2 as None beside the GroupNorms, as JAX's does)
    src, back = _leaves(tree), _leaves(out)
    assert back.keys() == src.keys()
    assert all(np.array_equal(back[k], src[k]) for k in src)
    extra = {k[-1] for k, v in want.items() if v is None} - {
        k[-1] for k, v in flatten_paths(tree).items() if v is None}
    assert extra <= {"bn1", "bn2"}


def test_bare_state_dict_and_pth_round_trip(tmp_path):
    """A bare state dict (no wrapper, no prefix) of tensors, through a
    .pth file loaded with weights_only, converts as the wrapped one."""
    name, kwargs = CASES["default"]
    tree = _init("default")
    sd = {k: torch.from_numpy(v.copy())
          for k, v in reference_state_dict(tree, name).items()}
    path = tmp_path / "ref.pth"
    torch.save(sd, path)
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    got = _leaves(convert_checkpoint(loaded, name, kwargs, device=CPU))
    want = _leaves(tree)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_converted_leaves_are_copies():
    """Writing into the state dict's tensors after the conversion leaves
    the converted tree as it was (the aliasing reason of JAX's `_to_np`)."""
    name, kwargs = CASES["bsrnn"]
    sd = {k: torch.from_numpy(v.copy())
          for k, v in reference_state_dict(_init("bsrnn"), name).items()}
    out = convert_checkpoint(sd, name, kwargs, device=CPU)
    before = {k: v.clone() for k, v in flatten_paths(out).items()
              if v is not None}
    for t in sd.values():
        t.add_(1.0)
    after = flatten_paths(out)
    assert all(torch.equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize("case", ["default", "lisennet"])
def test_a_missing_key_raises_naming_it(case):
    name, kwargs = CASES[case]
    sd = dict(reference_state_dict(_init(case), name))
    # a weight the converters read (a bias may be absent, and without a
    # weight-norm pair's original0 they look for the plain weight)
    key = sorted(k for k in sd if k.endswith(".weight"))[0]
    del sd[key]
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        convert_checkpoint(sd, name, kwargs, device=CPU)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        jax_convert(sd, name, kwargs)


def test_unknown_model_and_no_card():
    with pytest.raises(NotImplementedError):
        convert_checkpoint({}, "nope", {}, device=CPU)
    if not torch.cuda.is_available():
        name, kwargs = CASES["default"]
        sd = reference_state_dict(_init("default"), name)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert_checkpoint(sd, name, kwargs)


@pytest.mark.parametrize("case", ["default", "bsrnn", "fspen"])
def test_forward_on_converted_trees_matches_jax(case):
    """JAX's forward on its converted tree against the port's forward on
    its own, float32."""
    name, kwargs = CASES[case]
    ckpt = reference_checkpoint(_init(case), name)
    jm = jax_get_model(name, **kwargs)
    tm = get_model(name, **kwargs)
    jv = jax_convert(ckpt, name, kwargs)
    tv = convert_checkpoint(ckpt, name, kwargs, device=CPU)
    hop = kwargs.get("hop_size", 256)
    wav = np.random.default_rng(3).standard_normal(
        (2, hop * 12)).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(functools.partial(jm.forward, train=False))(
        jv, wav)[0])
    with torch.no_grad():
        got = tm.forward(tv, torch.from_numpy(wav))[0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
