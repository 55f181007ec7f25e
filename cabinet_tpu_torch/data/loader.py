"""Prefetching batch loader on threads (counterpart of
`cabinet_tpu.data.loader.DataLoader`).

Worker threads decode (zlib and numpy release the GIL for the heavy parts),
a bounded in-order window of futures keeps `prefetch` batches ready, and
batches come out as stacked NHWC numpy arrays. The batch order is the JAX
package's for any `shuffle`, `seed`, `set_epoch` and `shard`; when the
consumer stops early, the futures not yet started are cancelled and the
pool is shut down.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np


class DataLoader:
    """Iterates (images, labels) batches over a map-style dataset.

    Args:
        dataset: has __len__ and __getitem__ -> (image HWC f32, label HW i64);
            may expose set_epoch(epoch).
        batch_size: per-host batch size.
        shuffle: reshuffle each epoch from (seed, epoch).
        drop_last: drop the trailing partial batch.
        num_workers: decode threads (0 = synchronous).
        prefetch: batches kept ready beyond the one being consumed.
        shard: (index, count): this process reads every count-th sample of
            the epoch's order from `index` on (multi-process loading).
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        shard: Optional[Tuple[int, int]] = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self.seed = seed
        self.prefetch = max(1, int(prefetch))
        self.shard = shard
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng([self.seed, self.epoch]).permutation(n)
        if self.shard is not None:
            pid, nproc = self.shard
            order = order[pid::nproc]
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @staticmethod
    def _collate(samples: List[Tuple[np.ndarray, ...]]) -> Tuple[np.ndarray, ...]:
        return tuple(np.stack(field) for field in zip(*samples))

    def close(self) -> None:
        """Nothing to stop: a pass's threads end with it (the process
        loader's `close` stops its workers)."""

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        order = self._indices()
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        if self.num_workers <= 0:
            for batch_idx in batches:
                yield self._collate([self.dataset[int(i)] for i in batch_idx])
            self.set_epoch(self.epoch + 1)
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(batch_idx) -> List[Future]:
                return [pool.submit(self.dataset.__getitem__, int(i))
                        for i in batch_idx]

            inflight: List[List[Future]] = []
            it = iter(batches)
            try:
                for _ in range(self.prefetch + 1):
                    b = next(it, None)
                    if b is None:
                        break
                    inflight.append(submit(b))
                while inflight:
                    current = inflight.pop(0)
                    b = next(it, None)
                    if b is not None:
                        inflight.append(submit(b))
                    yield self._collate([f.result() for f in current])
            finally:
                for futs in inflight:
                    for f in futs:
                        f.cancel()
        self.set_epoch(self.epoch + 1)
