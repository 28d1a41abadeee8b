"""Training wrappers by the config's `wrapper` name."""
from __future__ import annotations

import importlib


def get_wrapper(name: str):
    """The ModelWrapper class of wrappers/<name>.py (ns or ns_shard)."""
    if name not in ("ns", "ns_shard"):
        raise NotImplementedError(
            f"wrapper {name!r} is not ported yet (ROADMAP queue 1, "
            '"Training, end to end on one card": the DNS recipe)')
    module = importlib.import_module(f"{__name__}.{name}")
    return module.ModelWrapper


__all__ = ["get_wrapper"]
