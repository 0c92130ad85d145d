"""Host input pipeline (copy of agcn_tpu/data/pipeline.py).

Replaces torch DataLoader + DistributedSampler (reference
feeders/loader.py:365-394, utils/processor.py:479-540): each data rank
iterates its shard of a per-epoch permutation, collates
numpy batches (`collate(batch, rng)`: the dense stack by default, the SGN
segment collate from `make_sgn_collate`), and a background thread keeps
`PREFETCH` batches ahead so host work overlaps device steps. The
permutation, the per-epoch item seeds and the collate's draws use the JAX
package's numpy seeding, so both packages see the same batches in the
same order.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from agcn_tpu_torch.data.sgn_collate import SegmentSampler

PREFETCH = 2  # batches the background thread keeps ahead


class BatchIterator:
    """Shuffling, sharded batch iterator over an indexable dataset.

    With `num_shards` > 1, shard `shard_index` takes every num_shards-th
    index of the permutation padded (by its own head) to a multiple of
    num_shards, so every shard sees the same count (the DistributedSampler
    contract; agcn_tpu/data/pipeline.py:24-60). The trainer's shards are
    the data ranks."""

    def __init__(self,
                 dataset,
                 batch_size: int,
                 shuffle: bool = False,
                 drop_last: bool = True,
                 seed: int = 0,
                 num_shards: int = 1,
                 shard_index: int = 0,
                 collate: Optional[Callable] = None,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.collate = collate or self._default_collate
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reseed the permutation (DistributedSampler.set_epoch parity,
        reference utils/processor.py:524-525)."""
        self.epoch = epoch

    @staticmethod
    def _default_collate(batch, rng):
        xs, ys, idxs = zip(*batch)
        return (np.stack(xs).astype(np.float32),
                np.asarray(ys, np.int64), np.asarray(idxs, np.int64))

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            # pad to a multiple so every shard sees the same count
            per = -(-n // self.num_shards)
            padded = np.concatenate(
                [order, order[: per * self.num_shards - n]])
            order = padded[self.shard_index::self.num_shards]
        return order

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _iter_batches(self) -> Iterator:
        order = self._indices()
        rng = np.random.default_rng(
            (self.seed, self.epoch, self.shard_index))
        if hasattr(self.dataset, "seed"):
            self.dataset.seed(int(rng.integers(2 ** 31)))
        end = (len(order) // self.batch_size * self.batch_size
               if self.drop_last else len(order))
        pool = None
        if self.num_workers > 1:
            # item loading/augmentation parallelized across threads:
            # numpy releases the GIL in the heavy ops, so threads overlap
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(self.num_workers)
        try:
            for start in range(0, end, self.batch_size):
                idx = order[start:start + self.batch_size]
                if pool is not None:
                    batch = list(pool.map(
                        lambda i: self.dataset[int(i)], idx))
                else:
                    batch = [self.dataset[int(i)] for i in idx]
                yield self.collate(batch, rng)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer went away, so an
            # abandoned iterator can't pin the thread + `PREFETCH` batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._iter_batches():
                    if not _put(item):
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # consumer closed early (break/exception/GC): release the
            # producer so _iter_batches' finally shuts its pool down
            stop.set()


def make_sgn_collate(sampler: SegmentSampler, train: bool,
                     multi_crop: bool = False) -> Callable:
    def collate(batch, rng):
        x, s, y, idx = sampler.collate(batch, rng, train=train,
                                       multi_crop=multi_crop)
        return x, y, idx
    return collate
