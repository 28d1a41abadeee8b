"""The port's MACs calculators (models/macs.py) against the JAX package's.

Every config under configs/ whose model has a calculator gives the same
numbers in both packages (the port reads the config without pyyaml);
the others raise in both. The paper's totals hold as in
tests/test_macs_and_scripts.py.
"""
import contextlib
import glob
import io
import os
import runpy
import sys

import pytest

from fastenhancer_tpu.models import macs as jax_macs
from fastenhancer_tpu_torch.models import macs

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True)
    if "shard_test" not in p)


def test_calculators_are_jax_s():
    assert macs.CALCULATORS.keys() == jax_macs.CALCULATORS.keys()


@pytest.mark.parametrize("config", CONFIGS)
def test_macs_for_config_equals_jax(config):
    path = os.path.join(REPO, config)
    try:
        want = jax_macs.macs_for_config(path)
    except ValueError:
        with pytest.raises(ValueError, match="no MACs calculator"):
            macs.macs_for_config(path)
        return
    got = macs.macs_for_config(path)
    assert got == want and list(got) == list(want)


@pytest.mark.parametrize("size,expected_m", [
    ("t", 60), ("b", 262), ("s", 664), ("m", 2900), ("l", 12000)])
def test_fastenhancer_macs_match_paper(size, expected_m):
    """Paper table 1 MACs (README.md:144-251)."""
    total = macs.macs_for_config(
        os.path.join(REPO, f"configs/fastenhancer/{size}.yaml"))["total"]
    assert abs(total / 1e6 - expected_m) / expected_m < 0.03, total / 1e6


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
def test_module_entry_prints_what_jax_prints(monkeypatch):
    """`python -m fastenhancer_tpu_torch.models.macs CONFIG` with pyyaml
    blocked prints the JAX entry's lines."""
    config = os.path.join(REPO, "configs/others/fspen.yaml")
    outs = []
    for module in ("fastenhancer_tpu.models.macs",
                   "fastenhancer_tpu_torch.models.macs"):
        monkeypatch.setattr(sys, "argv", ["macs", config])
        if module.startswith("fastenhancer_tpu_torch"):
            monkeypatch.setitem(sys.modules, "yaml", None)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_module(module, run_name="__main__")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "total" in outs[1]
