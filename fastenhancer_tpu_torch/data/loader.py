"""Host-side batching loader: thread-pool prefetch feeding numpy batches.

A copy of fastenhancer_tpu/data/loader.py (the port imports nothing of the
JAX package). Items are loaded by a thread pool (wav decode releases the
GIL in numpy) and whole batches are prefetched ahead of the train step; an
error in a worker is raised to the caller at the batch it would have made.
Variable-length batches may be padded up to a `pad_multiple`, so that
evaluation over length-sorted batches meets a bounded set of shapes.
Under several ranks each rank serves its stride of the batches,
`process_stride=(rank, world)`, wrap-padded so that every rank serves as
many batches as the others (DistributedSampler's padding).
"""
from __future__ import annotations

import queue
import threading
import typing as tp
from concurrent.futures import ThreadPoolExecutor

import numpy as np

Batch = tp.Dict[str, tp.Any]


def collate(items: tp.Sequence[tp.Dict[str, tp.Any]],
            pad_multiple: int = 1) -> Batch:
    """Pad the last axis of array values to the (rounded-up) max length.

    *_len keys -> int64 vector, filename/transcript -> lists.
    """
    out: Batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if key in ("filename", "transcript"):
            out[key] = list(vals)
        elif key.endswith("_len"):
            out[key] = np.asarray(vals, np.int64)
        else:
            max_len = max(v.shape[-1] for v in vals)
            max_len = ((max_len + pad_multiple - 1) // pad_multiple) * pad_multiple
            lead = vals[0].shape[:-1]
            buf = np.zeros((len(vals), *lead, max_len), vals[0].dtype)
            for i, v in enumerate(vals):
                buf[i, ..., : v.shape[-1]] = v
            out[key] = buf
    return out


class DataLoader:
    """Iterable over collated batches with background prefetch.

    A short tail batch is kept, or dropped with drop_last. With
    process_stride=(rank, world) this rank serves batches[rank::world] of
    the list wrap-padded to a multiple of world.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 4,
        drop_last: bool = False,
        pad_multiple: int = 1,
        prefetch: int = 2,
        process_stride: tp.Tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.pad_multiple = pad_multiple
        self.prefetch = prefetch
        self.process_stride = process_stride

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            total = n // self.batch_size
        else:
            total = (n + self.batch_size - 1) // self.batch_size
        w = self.process_stride[1]
        return -(-total // w)

    def _index_batches(self) -> tp.List[tp.List[int]]:
        n = len(self.dataset)
        idx = list(range(n))
        batches = [idx[i: i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        r, w = self.process_stride
        if w > 1:
            # every rank serves as many batches: unequal counts would
            # leave a rank waiting in a step's collectives
            if len(batches) % w:
                batches = batches + batches[: w - len(batches) % w]
            return batches[r::w]
        return batches

    def __iter__(self) -> tp.Iterator[Batch]:
        batches = self._index_batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            from .shard import _put_until_stop

            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, b))
                        if not _put_until_stop(
                                q, collate(items, self.pad_multiple), stop):
                            return
            except BaseException as e:  # propagate: a dead loader must not
                _put_until_stop(q, e, stop)  # silently yield empty epochs
                return
            finally:
                _put_until_stop(q, None, stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
