"""Host input pipeline (copy of agcn_tpu/data/pipeline.py:21-150).

Replaces torch DataLoader (reference feeders/loader.py:365-394,
utils/processor.py:479-540): iterates a per-epoch permutation, collates
numpy batches, and a background thread keeps `PREFETCH` batches ahead so
host work overlaps device steps. The permutation and the per-epoch item
seeds use the JAX package's numpy seeding, so both packages see the same
batches in the same order. Host sharding waits for the data-parallel
port, the SGN collate for SGN.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

PREFETCH = 2  # batches the background thread keeps ahead


class BatchIterator:
    """Shuffling batch iterator over an indexable dataset."""

    def __init__(self,
                 dataset,
                 batch_size: int,
                 shuffle: bool = False,
                 drop_last: bool = True,
                 seed: int = 0,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reseed the permutation (DistributedSampler.set_epoch parity,
        reference utils/processor.py:524-525)."""
        self.epoch = epoch

    @staticmethod
    def _collate(batch):
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
        return order

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _iter_batches(self) -> Iterator:
        order = self._indices()
        # (seed, epoch, shard 0): the JAX package's per-shard stream
        rng = np.random.default_rng((self.seed, self.epoch, 0))
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
                yield self._collate(batch)
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
