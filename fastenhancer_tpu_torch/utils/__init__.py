from .tree import tree_leaves, tree_map, cast_floating
from .bridge import from_jax, to_numpy

__all__ = ["tree_leaves", "tree_map", "cast_floating", "from_jax",
           "to_numpy"]
