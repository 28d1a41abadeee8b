"""Model registry: `get_model("fastenhancer.default", **model_kwargs)`.

Only FastEnhancer's default model is ported so far; every other name of the
JAX package's registry (fastenhancer_tpu/models/__init__.py) raises
NotImplementedError until its port lands (ROADMAP queue 1).
"""
import typing as tp

from .fastenhancer import default as _fastenhancer_default


def get_model_class(name: str) -> tp.Type:
    if name != "fastenhancer.default":
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP queue 1); "
            "the port has 'fastenhancer.default'")
    return _fastenhancer_default.Model


def get_model(name: str, **model_kwargs):
    return get_model_class(name)(**model_kwargs)


__all__ = ["get_model", "get_model_class"]
