"""The port's config reader (utils/yaml_subset.py, utils/hparams.py) against
pyyaml and the JAX package's get_hparams.

The card has no pyyaml, so the port reads configs/ with its own YAML
subset reader; it must give what `yaml.safe_load` gives on every config,
and its writer's output must read back equal through both readers.
"""
import glob
import math
import os

import pytest
import yaml

from fastenhancer_tpu.utils.hparams import get_hparams as jget_hparams
from fastenhancer_tpu_torch import presets
from fastenhancer_tpu_torch.utils import yaml_subset
from fastenhancer_tpu_torch.utils.hparams import HParams, get_hparams

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
                 for p in glob.glob(os.path.join(REPO, "configs", "**",
                                                 "*.yaml"), recursive=True))


def _read(rel):
    with open(os.path.join(REPO, "configs", rel), encoding="utf-8") as f:
        return f.read()


def test_every_config_is_found():
    assert len(CONFIGS) >= 40


@pytest.mark.parametrize("rel", CONFIGS)
def test_reader_equals_safe_load(rel):
    raw = _read(rel)
    assert yaml_subset.load(raw) == yaml.safe_load(raw)


@pytest.mark.parametrize("rel", CONFIGS)
def test_writer_reads_back_equal(rel):
    config = yaml.safe_load(_read(rel))
    text = yaml_subset.dump(config)
    assert yaml_subset.load(text) == config
    assert yaml.safe_load(text) == config


# YAML 1.1 scalars as PyYAML resolves them, flow collections over lines,
# quoting, comments and the block forms the configs use
SCALARS = ["1e-5", "1.0e-05", "-1.5e+3", "3e+2", "1.", ".5", ".inf",
           "-.inf", "'002'", "002", "017", "0x1F", "0b101", "1_000", "1:30",
           "1:30.5", "+1", "-0", "yes", "No", "on", "OFF", "True", "tRue",
           "y", "n", "~", "null", "NULL", "", "'it''s'", '"a\\tb\\u00e9"',
           "''", '""', "a, b", "foo[0-9]", "x # comment", "'a # b'",
           "dec_post\\.3\\.scale", "(en|de)coder\\.\\d\\.2\\.weight"]
DOCUMENTS = [
    "[a, [b, c], {d: e}]",
    "{a: , b: 1}",
    "- a\n- b: 1\n  c: [1,\n    2]\n-\n  - x\n",
    "a:\n- 1\n- 2\nb: x",
    "a:\n  - - 1\n    - 2\n  - 3",
    "k: {x: 'a,\n    b', y: [1,\n    2]}  # tail\n",
    "# head\nk:\n    -   regex_list: ['a\\.b$', c]\n        w: 0\n    -   p: 1\n",
]


@pytest.mark.parametrize("text", [f"k: {s}" for s in SCALARS] + DOCUMENTS)
def test_reader_scalars_and_forms_equal_safe_load(text):
    want = yaml.safe_load(text)
    got = yaml_subset.load(text)
    if isinstance(want, dict) and any(isinstance(v, float) and math.isnan(v)
                                      for v in want.values()):
        assert math.isnan(got["k"])
    else:
        assert got == want and type(got) is type(want)
        if isinstance(want, dict):
            assert all(type(got[k]) is type(want[k]) for k in want)


@pytest.mark.parametrize("text", ["k: .nan", "k: .NaN"])
def test_reader_nan(text):
    assert math.isnan(yaml_subset.load(text)["k"])
    assert math.isnan(yaml.safe_load(text)["k"])


@pytest.mark.parametrize("text", ["k: a: b", "k: &x 1", "k: |\n  text",
                                  "k: 2024-01-02", "a: 1\n---\nb: 2",
                                  "k: [1, 2"])
def test_reader_refuses_what_it_does_not_cover(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)


def test_writer_scalars_read_back_equal():
    data = {"a": [1e-5, 1e20, 0.1, -0.0, 3, True, None, "yes", "1e-5",
                  "x'y", "é\n", "", "002", "a b", "[x]", {}, [],
                  [[1, 2], [3]],
                  [{"p": {"q": [1]}, "r": 2}, 5, [{"s": 1}]]],
            "b": {"c": {"d": "null"}}, 7: "seven", "inf": [math.inf]}
    text = yaml_subset.dump(data)
    assert yaml_subset.load(text) == data == yaml.safe_load(text)


def _override_params(tmp_path):
    return ["train.max_epochs=3", "train.optimizer_kwargs.lr=1e-3",
            "data.valid.clean_dir=" + str(tmp_path / "clean"),
            "model_kwargs.kernel_size=[4, 3]", "pesq.metrics_to_calculate="
            "{'pesq': False, 'stoi': True}", "train.clip_grad=norm"]


@pytest.mark.parametrize("rel", ["fastenhancer_shard/t.yaml",
                                 "fastenhancer/b.yaml",
                                 "ablation/dprnn_b.yaml"])
def test_get_hparams_matches_jax_with_overrides_and_save(rel, tmp_path):
    """Overrides, the saved run-dir config (written by each package's
    writer) and resume from the run dir with config_dir=None."""
    config = os.path.join(REPO, "configs", rel)
    params = _override_params(tmp_path)
    if "pesq" not in yaml.safe_load(_read(rel)):
        params = params[:-2] + params[-1:]
    want = jget_hparams(config, str(tmp_path / "jax"), save=True,
                        params=params)
    got = get_hparams(config, str(tmp_path / "port"), save=True,
                      params=params)
    assert isinstance(got, HParams)
    assert got.to_dict() == want.to_dict() | {"base_dir": got.base_dir}
    assert got.train.max_epochs == 3 and got["train"]["optimizer_kwargs"][
        "lr"] == 1e-3
    # each run dir's config.yaml reads back equal through either package
    for run in ("jax", "port"):
        for load in (get_hparams, jget_hparams):
            back = load(None, str(tmp_path / run)).to_dict()
            back.pop("base_dir")
            assert back == {k: v for k, v in want.to_dict().items()
                            if k != "base_dir"}, (run, load)


def test_get_hparams_saves_the_raw_file_without_overrides(tmp_path):
    config = os.path.join(REPO, "configs", "fastenhancer_shard", "t.yaml")
    get_hparams(config, str(tmp_path), save=True)
    with open(tmp_path / "config.yaml", encoding="utf-8") as f:
        assert f.read() == _read("fastenhancer_shard/t.yaml")


def test_get_hparams_errors_as_jax(tmp_path):
    config = os.path.join(REPO, "configs", "fastenhancer_shard", "t.yaml")
    for load in (get_hparams, jget_hparams):
        run = str(tmp_path / load.__module__.split(".")[0])
        with pytest.raises(RuntimeError, match="unknown key"):
            load(config, run, params=["train.no_such_key=1"])
        with pytest.raises(FileNotFoundError):
            load(None, run)
        load(config, run, save=True)
        with pytest.raises(FileExistsError):
            load(config, run, save=True)
        with pytest.raises(ValueError, match="force_save"):
            load(None, run, save=True, params=["train.max_epochs=2"])
        # force_save overwrites; a resume then reads the new value
        load(config, run, save=True, params=["train.max_epochs=2"],
             force_save=True)
        assert load(None, run).train.max_epochs == 2
        load(None, run, params=["train.max_epochs=5"], force_save=True)
        assert load(None, run).train.max_epochs == 5


def test_json_config(tmp_path):
    import json

    path = tmp_path / "c.json"
    path.write_text(json.dumps({"train": {"seed": 3}, "model": "x"}))
    hps = get_hparams(str(path), str(tmp_path / "run"), save=True,
                      params=["train.seed=4"])
    assert hps.train.seed == 4
    assert json.loads((tmp_path / "run" / "config.json").read_text()) == {
        "train": {"seed": 4}, "model": "x"}


def test_fe_t_shard_config_holds_the_preset():
    """The port's reader gives configs/fastenhancer_shard/t.yaml with
    presets.FE_T_SHARD's sections in it, as JAX's reader does
    (tests/test_torch_presets.py)."""
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
