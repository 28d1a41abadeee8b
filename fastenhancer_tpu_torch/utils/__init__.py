"""Tree helpers, the JAX bridge and the checkpoint converter; each name
is imported from its module at first use, so `utils.hparams` and
`utils.yaml_subset` load without torch."""
import importlib

_MODULES = {"tree_leaves": "tree", "tree_map": "tree", "tree_paths": "tree",
            "cast_floating": "tree", "from_jax": "bridge",
            "to_numpy": "bridge", "convert_checkpoint": "convert"}

__all__ = list(_MODULES)


def __getattr__(name):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_MODULES[name]}", __name__),
                    name)
    globals()[name] = value
    return value
