"""Training wrappers by the config's `wrapper` name."""
from __future__ import annotations

import importlib


def get_wrapper(name: str):
    """The ModelWrapper class of wrappers/<name>.py (ns, ns_shard or
    ns_on_the_fly)."""
    if name not in ("ns", "ns_shard", "ns_on_the_fly"):
        raise ValueError(f"unknown wrapper: {name!r}")
    module = importlib.import_module(f"{__name__}.{name}")
    return module.ModelWrapper


__all__ = ["get_wrapper"]
