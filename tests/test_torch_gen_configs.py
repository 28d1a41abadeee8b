"""The port's config builder, `gen_configs` and YAML writer against the
JAX package's builder, scripts/gen_configs.py and PyYAML.

The writer (`utils/yaml_subset.py::dump`) must give the bytes of
`yaml.dump(tree, sort_keys=False, indent=4, default_flow_style=None)`,
on the 41 generated configs and on generated trees of the subset, and its
text must read back equal through both readers; `gen_configs --check`
runs with pyyaml blocked; a run dir's config.yaml is JAX's byte for byte.
"""
import math
import os
import subprocess
import sys

import pytest
import yaml
from hypothesis import given, settings, strategies as st

from fastenhancer_tpu.configs import build_all as jax_build_all
from fastenhancer_tpu.utils.hparams import get_hparams as jax_get_hparams
from fastenhancer_tpu_torch.configs import build_all
from fastenhancer_tpu_torch.scripts import gen_configs
from fastenhancer_tpu_torch.utils import yaml_subset
from fastenhancer_tpu_torch.utils.hparams import get_hparams

from _torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILT = build_all()
JAX_BUILT = jax_build_all()
KEYS = sorted(JAX_BUILT)


def _pyyaml(tree):
    return yaml.dump(tree, sort_keys=False, indent=4,
                     default_flow_style=None)


def test_builder_has_jax_s_keys():
    assert len(KEYS) == 41 and list(BUILT) == list(JAX_BUILT)


@pytest.mark.parametrize("rel", KEYS)
def test_builder_equals_jax_and_writer_equals_pyyaml(rel):
    assert BUILT[rel] == JAX_BUILT[rel]
    text = yaml_subset.dump(BUILT[rel])
    assert text == _pyyaml(JAX_BUILT[rel])
    with open(os.path.join(REPO, "configs", rel + ".yaml"),
              encoding="utf-8") as f:
        assert gen_configs.HEADER + text == f.read()
    assert yaml_subset.load(text) == BUILT[rel] == yaml.safe_load(text)


def test_check_passes_without_pyyaml():
    code = ("import sys; sys.modules['yaml'] = None; "
            "from fastenhancer_tpu_torch.scripts.gen_configs import main; "
            "main(['--check'])")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STALE" not in r.stdout


def test_out_writes_the_repo_s_bytes_and_check_finds_a_stale_file(
        tmp_path, capsys):
    gen_configs.main(["--out", str(tmp_path)])
    for rel in KEYS:
        with open(os.path.join(REPO, "configs", rel + ".yaml"), "rb") as f:
            want = f.read()
        assert (tmp_path / (rel + ".yaml")).read_bytes() == want, rel
    gen_configs.main(["--check", "--out", str(tmp_path)])
    (tmp_path / "others" / "fspen.yaml").write_text("model: x\n")
    os.remove(tmp_path / "ablation" / "ln_b.yaml")
    with pytest.raises(SystemExit):
        gen_configs.main(["--check", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "STALE" in out and "fspen.yaml" in out and "ln_b.yaml" in out


# -- the writer on trees of the subset -----------------------------------------

TOKENS = ["yes", "No", "on", "null", "~", "", "1.0", "1e-5", "1e-05",
          "0x1F", "002", "1:30", "2024-01-02", "=", "<<", "---", "...",
          "- a", "a: b", "a:b", "x #y", "#x", "'q'", '"q"', "it's", "[x]",
          "{y}", "a, b", "?", "-", ":", ".inf", ".nan", "True", "dec_post"
          r"\.3\.scale", r"rf_block\.\d\.rnn\.parametrizations.+original0$",
          "é", "tab\there", "two  spaces", " lead", "trail ", "x\ny",
          "x\n", "\x00", "\x85"]
WORDS = st.text(alphabet="abcdefgh", min_size=1, max_size=12)
STRINGS = st.one_of(
    st.sampled_from(TOKENS),
    st.lists(WORDS, min_size=1, max_size=30).map(" ".join),
    st.text(alphabet=st.characters(min_codepoint=0x20, max_codepoint=0x7E)
            | st.sampled_from("\n\té\x85"), max_size=120))
FLOATS = st.one_of(st.sampled_from([1e-5, 1e-05, 1e20, 1e16, -0.0, 0.1,
                                    2.5e-8, math.inf, -math.inf]),
                   st.floats(allow_nan=False))
SCALARS = st.one_of(st.none(), st.booleans(), st.integers(), FLOATS,
                    STRINGS)
KEY = st.one_of(st.integers(0, 999), STRINGS.filter(
    lambda k: k and len(k) < 120 and not any(c in k for c in "\n\x85")))
TREES = st.recursive(
    SCALARS, lambda inner: st.one_of(
        st.lists(inner, max_size=40),
        st.dictionaries(KEY, inner, max_size=8)), max_leaves=80)


@settings(max_examples=200, deadline=None)
@given(TREES)
def test_writer_equals_pyyaml_on_generated_trees(tree):
    text = yaml_subset.dump(tree)
    assert text == _pyyaml(tree)
    assert yaml.safe_load(text) == tree
    assert yaml_subset.load(text) == tree


@pytest.mark.parametrize("tree", [
    {"k": list(range(60))},                            # a flow list > 80
    {"k": ["word " * 12 + str(i) for i in range(4)]},  # folded in flow
    {"k": "word " * 40},                               # folded plain
    {"k": "it's " * 30 + "\n" + "x" * 90},             # folded '...'
    {"k": "é " * 60},                                  # folded "..."
    {"k": [{"a": [1, {"b": []}], "c": {}}, [[1], [2, [3]]], {}]},
    {"a" * 122: 1}, {1.5: None, None: 2, True: "x"},
    1, "a", "", None, 1e-5, [], {}, "yes", "x\ny", "é",
])
def test_writer_equals_pyyaml_on_chosen_trees(tree):
    text = yaml_subset.dump(tree)
    assert text == _pyyaml(tree)
    assert yaml_subset.load(text) == tree == yaml.safe_load(text)


@pytest.mark.parametrize("tree,why", [
    ({"a" * 123: 1}, "simple key"),   # PyYAML writes '? ' keys from 128
    ({"": 1}, "simple key"),
    ({"x\ny": 1}, "simple key"),
    ({"a": [1], "b": None}, None),
])
def test_writer_refuses_what_load_cannot_read(tree, why):
    if why is None:
        shared = [1]
        tree = {"a": shared, "b": shared}  # PyYAML: an anchor and an alias
        why = "appears twice"
    with pytest.raises(ValueError, match=why):
        yaml_subset.dump(tree)


@pytest.mark.parametrize("rel", ["fastenhancer/b.yaml",
                                 "fastenhancer_shard/t.yaml",
                                 "others/lisennet.yaml",
                                 "shard_test/se_test.yaml"])
def test_run_dir_config_yaml_is_jax_s_bytes(rel, tmp_path):
    config = os.path.join(REPO, "configs", rel)
    params = ([] if rel.startswith("shard_test") else
              ["train.max_epochs=3", "train.optimizer_kwargs.lr=1e-3"])
    jax_get_hparams(config, str(tmp_path / "jax"), save=True, params=params)
    get_hparams(config, str(tmp_path / "port"), save=True, params=params)
    want = (tmp_path / "jax" / "config.yaml").read_bytes()
    assert (tmp_path / "port" / "config.yaml").read_bytes() == want
