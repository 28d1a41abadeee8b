"""fastenhancer_tpu_torch/presets.py against its sources, and the card
script's imports.

The presets are copies, so that the port and chip_smoke.py need neither the
JAX package nor a YAML reader; this holds them equal to what they copy,
read with the JAX package's own loader.
"""
import ast
import os

import pytest

from fastenhancer_tpu.utils.hparams import get_hparams
from fastenhancer_tpu_torch import presets

from __graft_entry__ import FLAGSHIP_KWARGS

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fe_b_is_the_flagship():
    assert presets.FE_B == FLAGSHIP_KWARGS


@pytest.mark.parametrize("name,config,model", [
    ("DPT_B", "ablation/dpt_b.yaml", "fastenhancer.dptransformer"),
    ("DPRNN_B", "ablation/dprnn_b.yaml", "fastenhancer.dprnn"),
    ("LN_B", "ablation/ln_b.yaml", "fastenhancer.ln"),
    ("TIME_KERNEL_B", "ablation/time_kernel_b.yaml",
     "fastenhancer.time_kernel"),
    ("NONCAUSAL_HUGE", "fastenhancer_dns/huge_noncausal.yaml",
     "fastenhancer.noncausal"),
    ("BSRNN_S", "others/bsrnn_s.yaml", "bsrnn"),
    ("FSPEN", "others/fspen.yaml", "fspen"),
    ("FSPEN", "others_dns/fspen.yaml", "fspen"),
    ("LISENNET", "others/lisennet.yaml", "lisennet"),
    ("LISENNET", "others_dns/lisennet.yaml", "lisennet")])
def test_preset_is_its_config(name, config, model):
    hps = get_hparams(os.path.join(REPO, "configs", *config.split("/")),
                      base_dir="")
    assert hps.model == model
    assert getattr(presets, name) == hps.model_kwargs.to_dict()


def test_fe_t_shard_is_its_config():
    """FE_T_SHARD holds configs/fastenhancer_shard/t.yaml's model, wrapper,
    train and valid sections whole, and the parts of `data` the training
    wrapper reads."""
    hps = get_hparams(os.path.join(REPO, "configs", "fastenhancer_shard",
                                   "t.yaml"), base_dir="").to_dict()
    p = presets.FE_T_SHARD
    for key in ("model", "model_kwargs", "wrapper", "train", "valid"):
        assert p[key] == hps[key], key
    data = hps["data"]
    assert p["data"]["train"] == {"mixer": data["train"]["mixer"]}
    assert p["data"]["valid"] == {"segment_size":
                                  data["valid"]["segment_size"]}
    for key in ("sampling_rate", "max_duration", "dereverberation"):
        assert p["data"][key] == data[key], key


def _import_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_only_the_port_torch_and_numpy():
    """chip_smoke.py imports the port, torch, numpy, scipy (which the
    port's wav resampling uses; phase 29 writes its MATLAB v5 RIR banks
    with `scipy.io.savemat`), the standard library and the reference
    state-dict writer of tests/, which imports only the standard
    library."""
    roots = _import_roots(os.path.join(REPO, "chip_smoke.py"))
    stdlib = {"gzip", "io", "json", "os", "shutil", "statistics",
              "subprocess", "sys", "tarfile", "tempfile", "time", "wave"}
    assert roots - stdlib == {"numpy", "scipy", "torch",
                              "fastenhancer_tpu_torch", "_torch_reference_sd"}
    helper = _import_roots(os.path.join(REPO, "tests",
                                        "_torch_reference_sd.py"))
    assert helper <= {"__future__", "typing"}


def test_all_lists_every_preset():
    """presets.__all__ names every preset dict the module defines."""
    names = {k for k, v in vars(presets).items()
             if k.isupper() and isinstance(v, dict)}
    assert set(presets.__all__) == names
