"""Config system: YAML/JSON -> recursive attr-dict with CLI dot-overrides.

A copy of fastenhancer_tpu/utils/hparams.py (the port imports nothing of
the JAX package) with the same contract:

  * `HParams` behaves as both an object (hp.train.losses) and a mapping
    (hp["train"], `in`, .items()).
  * `-p a.b.c=value` overrides parsed with ast.literal_eval (strings pass
    through verbatim).
  * run-dir persistence: configs are saved to `{base_dir}/config.yaml`; a
    second run with the same name must either match or pass force_save;
    resume with `config_dir=None` reloads the saved copy.

YAML goes through `utils/yaml_subset.py` (the card has no pyyaml), which
reads what `configs/` holds as `yaml.safe_load` does and writes a run
dir's config.yaml with the bytes the JAX package's `yaml.dump` gives.
There is one process, so `is_rank_zero` is always true.
"""
from __future__ import annotations

import ast
import json
import os
import typing as tp

from . import yaml_subset


def is_rank_zero() -> bool:
    return True


class HParams:
    """Recursive attribute dict over a plain config mapping."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if type(v) is dict:
                v = HParams(**v)
            setattr(self, k, v)

    # mapping protocol -------------------------------------------------------
    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def update(self, kwargs):
        for k, v in kwargs.items():
            self[k] = v

    def get(self, *args):
        return self.__dict__.get(*args)

    def pop(self, *args):
        return self.__dict__.pop(*args)

    def copy(self) -> "HParams":
        return HParams(**self.__dict__)

    def to_dict(self) -> tp.Dict[str, tp.Any]:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.to_dict() if isinstance(v, HParams) else v
        return out

    def __len__(self):
        return len(self.__dict__)

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value):
        setattr(self, key, value)

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return repr(self.__dict__)


def update_params(config: tp.Dict[str, tp.Any], params: tp.List[str]) -> None:
    """Apply 'a.b.c=value' overrides in place; unknown keys raise."""
    for param in params:
        key, value = param.split("=", 1)
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass  # keep as string
        parts = key.split(".")
        node = config
        for part in parts[:-1]:
            node = node[part]
        leaf = parts[-1]
        if leaf not in node:
            raise RuntimeError(f"'{param}' parameter not updated: unknown key")
        node[leaf] = value
        if is_rank_zero():
            print(f"'{leaf}={value}' updated")


def _dump_yaml(config, f):
    f.write(yaml_subset.dump(config))


def get_hparams(
    config_dir: tp.Optional[str] = None,
    base_dir: str = "",
    save: bool = False,
    params: tp.Optional[tp.List[str]] = None,
    force_save: bool = False,
) -> HParams:
    """Load (and optionally persist) a config.

    config_dir=None resumes from {base_dir}/config.{yaml,json}. With `save`,
    the config is written to the run dir; refusing to silently overwrite an
    existing one unless force_save.
    """
    params = params or []
    if config_dir is None:
        if params and save and not force_save:
            raise ValueError("config_dir=None with params and save=True "
                             "requires force_save")
        save = force_save
        for ext in ("yaml", "json"):
            cand = os.path.join(base_dir, f"config.{ext}")
            if os.path.exists(cand):
                config_dir = cand
                break
        else:
            raise FileNotFoundError(
                f"config.yaml or config.json not found in {base_dir!r}")

    with open(config_dir, "r", encoding="utf-8") as f:
        raw = f.read()

    if config_dir.endswith(".json"):
        config = json.loads(raw)
        config_file, dump = "config.json", json.dump
    else:
        config = yaml_subset.load(raw)
        config_file, dump = "config.yaml", _dump_yaml

    if params:
        update_params(config, params)

    if save:
        os.makedirs(base_dir, exist_ok=True)
        target = os.path.join(base_dir, config_file)
        if os.path.exists(target) and not force_save:
            raise FileExistsError(f"{target} already exists. Set --force_save.")
        with open(target, "w") as f:
            if params:
                dump(config, f)
            else:
                f.write(raw)

    hps = HParams(**config)
    hps.base_dir = base_dir
    return hps
