"""Device-side data: the shard recipe's mixer and its batch type."""
from .shard_mixer import (
    DynamicMixer,
    ShardBatch,
    batch_convolve_rir,
    get_early_rir,
    get_rts_rir,
    get_weighted_rir,
)

__all__ = ["DynamicMixer", "ShardBatch", "batch_convolve_rir",
           "get_early_rir", "get_rts_rir", "get_weighted_rir"]
