from .tree import tree_leaves, tree_map, tree_paths, cast_floating
from .bridge import from_jax, to_numpy
from .convert import convert_checkpoint

__all__ = ["tree_leaves", "tree_map", "tree_paths", "cast_floating",
           "from_jax", "to_numpy", "convert_checkpoint"]
