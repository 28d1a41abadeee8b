"""Host-side data (wav IO, the paired-wav and on-the-fly datasets, the
threaded loader, the shard reader) and the device-side mixers.

`get_dataset_dataloader` is the counterpart of
fastenhancer_tpu/data/__init__.py's: a mode-keyed dataset with per-mode
batch-size and worker overrides; `data.dataset` may be one name or a
{mode: name} map. Under several ranks (`parallel`) each rank loads its
own stride of the batches and the shard reader seeds by rank; the
showcase (`infer`) loader serves every file on one rank.
"""
from __future__ import annotations

import importlib
import typing as tp

# each name is imported from its module at first use, so the host-only
# modules (audio_io, shard) load without torch
_MODULES = {
    "read_wav": "audio_io", "resample": "audio_io",
    "wav_duration": "audio_io", "write_wav": "audio_io",
    "DataLoader": "loader", "collate": "loader",
    "NSDataset": "noise_suppression",
    "DynamicBatchLPF": "ns_on_the_fly", "NSOnTheFlyDataset": "ns_on_the_fly",
    "SNRMixer": "ns_on_the_fly", "batch_rir_conv": "ns_on_the_fly",
    "DynamicMixer": "shard_mixer", "ShardBatch": "shard_mixer",
    "batch_convolve_rir": "shard_mixer", "get_early_rir": "shard_mixer",
    "get_rts_rir": "shard_mixer", "get_weighted_rir": "shard_mixer",
}


def __getattr__(name):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_MODULES[name]}", __name__),
                    name)
    globals()[name] = value
    return value


def get_dataset_dataloader(hps, mode: str, keys: tp.List[str]
                           ) -> tp.Tuple[tp.Any, tp.Any]:
    """(dataset, loader) for `mode` in train/valid/pesq/infer; `hps` is an
    HParams. Datasets: NoiseSuppression (paired wavs),
    NoiseSuppressionOnTheFly (clean and noise drawn and mixed per item),
    and the shard datasets, which are their own (endless) loaders. The
    showcase `infer` mode reads `data.infer.files` (every file: one
    process), `infer.batch_size` (1) and `infer.num_workers` (0), and pads
    a batch to a multiple of 16 hops, as pesq mode does; "wav_len" keeps
    each file's length. Under W ranks a paired-wav or on-the-fly loader
    serves this rank's stride of batches of `batch_size`, and the dataset
    shuffles length-sorted blocks of W * batch_size items, so W ranks at B
    see the items of one process at W * B."""
    from .. import parallel
    from .loader import DataLoader
    from .noise_suppression import NSDataset
    from .ns_on_the_fly import NSOnTheFlyDataset

    world, rank = parallel.world(), parallel.rank()
    if mode == "infer":
        world, rank = 1, 0
    dataset_name = hps["data"]["dataset"]
    if not isinstance(dataset_name, str):
        dataset_name = dataset_name[mode]

    if dataset_name == "NoiseSuppression":
        cls = NSDataset
    elif dataset_name == "NoiseSuppressionOnTheFly":
        cls = NSOnTheFlyDataset
    elif dataset_name in ("ShardOnTheFly", "ShardSegment"):
        from .shard import build_shard_dataloader

        return build_shard_dataloader(hps, mode=mode, keys=keys,
                                      segment=(dataset_name == "ShardSegment"),
                                      rank=rank)
    else:
        raise ValueError(f"unknown dataset: {dataset_name}")

    hp = hps["train"]
    batch_size = getattr(hp, "batch_size", 1)
    num_workers = getattr(hp, "num_workers", 2)
    drop_last = getattr(hp, "drop_last", False)
    pad_multiple = 1
    if mode == "valid":
        sec = getattr(hps, "valid", {})
        batch_size = getattr(sec, "batch_size", batch_size)
        num_workers = getattr(sec, "num_workers", num_workers)
        drop_last = getattr(sec, "drop_last", drop_last)
    elif mode == "infer":
        sec = getattr(hps, "infer", {})
        batch_size = getattr(sec, "batch_size", 1)
        num_workers = getattr(sec, "num_workers", 0)
        pad_multiple = 16 * getattr(hps["model_kwargs"], "hop_size", 256)
    elif mode == "pesq":
        sec = getattr(hps, "pesq", {})
        batch_size = getattr(sec, "batch_size", batch_size)
        num_workers = getattr(sec, "num_workers", num_workers)
        # length-sorted unsegmented eval, padded to 16 hops: a bounded set
        # of shapes
        pad_multiple = 16 * getattr(hps["model_kwargs"], "hop_size", 256)
    elif mode != "train":
        raise ValueError(f"unknown dataset mode: {mode}")

    dataset = cls(hps["data"], keys, mode=mode,
                  batch_size=batch_size * world)
    loader = DataLoader(dataset, batch_size=batch_size,
                        num_workers=max(num_workers, 1),
                        drop_last=drop_last, pad_multiple=pad_multiple,
                        process_stride=(rank, world))
    return dataset, loader


__all__ = [
    "get_dataset_dataloader", "NSDataset", "NSOnTheFlyDataset",
    "SNRMixer", "DynamicBatchLPF", "batch_rir_conv", "DataLoader", "collate",
    "read_wav", "write_wav", "wav_duration", "resample",
    "DynamicMixer", "ShardBatch", "batch_convolve_rir", "get_early_rir",
    "get_rts_rir", "get_weighted_rir",
]
