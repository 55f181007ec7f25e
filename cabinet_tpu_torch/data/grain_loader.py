"""The batch loader on worker processes (counterpart of
`cabinet_tpu.data.grain_loader`), selected by `runtime.loader=grain`.

The JAX package builds it on grain. Grain is not installed on the card's
machine and cannot be, so here the processes are
`torch.utils.data.DataLoader` workers, kept for the loader's life
(`persistent_workers`), so an epoch does not start them again. They are
never forked from the caller, which may hold a CUDA context or other
threads: a `forkserver` process, started fresh with torch and the datasets
imported once, forks them, so each worker does not import torch again; it
serves every later loader, and the caller's exit stops and reaps it
(`stop_servers`), so no process outlives the caller. A platform
without a forkserver (Windows) cannot import this module.

The contract is the JAX package's `GrainLoader`: `len()` is the batches of an
epoch, `set_epoch(e)` reshuffles from `(seed, e)`, and each `__iter__` yields
one epoch of stacked numpy batches, `(images f32 (B, H, W, 3), labels i64
(B, H, W))` or the canvas datasets' `(u8 canvas, label, hw)`; iterating again
within an epoch gives the same batches (the epoch does not advance at the end
of a pass, as it does in `data.loader.DataLoader`).

Two parts differ from grain's, by design:
  - the order within an epoch is `default_rng([seed, epoch]).permutation` of
    the records, the thread loader's, not grain's index shuffle. Unsharded,
    both of the port's loaders so yield the same batches bit for bit, since
    a sample is a function of (seed, epoch, idx);
  - `shard=(index, count)` is grain's: shard `index` owns the contiguous
    records [index * (n // count), (index + 1) * (n // count)), shuffled
    within, the remainder dropped, the same set every epoch.

The workers read one record each at a time, in order, and the calling
process stacks them into batches, so the first batch of an epoch waits for
one record, not for a batch. A worker holds its own copy of the dataset,
pickled when the workers start: each record carries the epoch of
`set_epoch`, and the worker calls `dataset.set_epoch` with it before reading.
A worker that raises raises in the caller; one that dies ends the pass with
a `RuntimeError` (torch checks its workers every few seconds). `close()`
stops the workers; so does collecting the loader.
"""

from __future__ import annotations

import itertools
import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import multiprocessing.util
import os
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from cabinet_tpu_torch.data.loader import DataLoader

# The workers' start method; the server imports these once, when it starts,
# before it forks the workers.
_FORKSERVER = multiprocessing.get_context("forkserver")
_FORKSERVER.set_forkserver_preload(["__main__", "torch", "cabinet_tpu_torch.data.datasets"])



def stop_servers() -> None:
    """Stop and reap the forkserver that forks the workers and the resource
    tracker that multiprocessing starts beside it; a later loader starts
    both again. Runs by itself when the calling process exits."""
    multiprocessing.forkserver._forkserver._stop()
    tracker = multiprocessing.resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._fd is not None and tracker._pid is not None:
            os.close(tracker._fd)  # its pipe's end: the tracker exits
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None


# At exit, after multiprocessing has stopped and joined the workers of any
# loader still open (priority >= 0) and before it removes its temporary
# directory, which holds the forkserver's socket (priority -100).
multiprocessing.util.Finalize(None, stop_servers, exitpriority=-50)


class _EpochRecords:
    """The worker's view of the dataset: record (epoch, idx) is
    `dataset[idx]` read under `dataset.set_epoch(epoch)`; epoch None reads
    it under whatever epoch the dataset holds."""

    def __init__(self, dataset: Any) -> None:
        self.dataset = dataset
        self.epoch: Optional[int] = None

    def __getitem__(self, key: Tuple[Optional[int], int]) -> Tuple[np.ndarray, ...]:
        epoch, idx = key
        if epoch is not None and epoch != self.epoch:
            self.dataset.set_epoch(epoch)
            self.epoch = epoch
        return tuple(self.dataset[idx])


class _Keys:
    """The sampler: the (dataset epoch, record index) keys of the pass that
    `GrainLoader.__iter__` sets before it starts one."""

    def __init__(self) -> None:
        self.keys: List[Tuple[Optional[int], int]] = []

    def __iter__(self):
        return iter(self.keys)

    def __len__(self) -> int:
        return len(self.keys)


def _one(sample):
    """collate_fn of one record: keeps its numpy arrays (torch's default
    would make tensors of them)."""
    return sample


class GrainLoader:
    """Iterates batches over a map-style dataset on worker processes.

    Args:
        dataset: has __len__ and __getitem__ -> a tuple of numpy arrays; may
            expose set_epoch(epoch). It must pickle.
        batch_size: per-process batch size.
        shuffle: reshuffle each epoch from (seed, epoch).
        drop_last: drop the trailing partial batch.
        num_workers: worker processes (0: read in the calling process).
        seed: the shuffle's seed.
        shard: optional (index, count), grain's contiguous equal shards.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        shard: Optional[Tuple[int, int]] = None,
    ) -> None:
        if shard is not None and not 0 <= int(shard[0]) < int(shard[1]):
            raise ValueError(f"shard must be (index, count) with 0 <= index < count, "
                             f"got {shard}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self.seed = int(seed)
        self.shard = None if shard is None else (int(shard[0]), int(shard[1]))
        self._epoch = 0
        self._dataset_epoch: Optional[int] = None
        self._keys = _Keys()
        self._loader = None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
            self._dataset_epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        """This epoch's records in order: the shard's, then shuffled."""
        n = len(self.dataset)
        first = 0
        if self.shard is not None:
            index, count = self.shard
            n //= count
            first = index * n
        order = np.arange(first, first + n)
        if self.shuffle:
            order = order[np.random.default_rng([self.seed, self._epoch]).permutation(n)]
        if self.drop_last:
            order = order[:len(order) // self.batch_size * self.batch_size]
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.shard is not None:
            n //= self.shard[1]
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _records(self) -> torch.utils.data.DataLoader:
        """The torch loader of single records; its workers start on the
        first pass and stay."""
        if self._loader is None:
            workers = self.num_workers > 0
            # records in flight: the thread loader's 3 batches (its
            # default prefetch of 2 beyond the one being consumed)
            in_flight = 3 * self.batch_size
            self._loader = torch.utils.data.DataLoader(
                _EpochRecords(self.dataset), batch_size=None, sampler=self._keys,
                collate_fn=_one, num_workers=self.num_workers,
                persistent_workers=workers,
                prefetch_factor=(max(2, -(-in_flight // self.num_workers))
                                 if workers else None),
                multiprocessing_context=_FORKSERVER if workers else None,
                # the workers' seeds come from here, not from torch's global
                # generator, which the caller's model init draws from
                generator=torch.Generator().manual_seed(self.seed))
        return self._loader

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        records = self._records()
        self._keys.keys = [(self._dataset_epoch, int(i)) for i in self._indices()]
        batch: List[Tuple[np.ndarray, ...]] = []
        for sample in records:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield DataLoader._collate(batch)
                batch = []
        if batch:
            yield DataLoader._collate(batch)

    def close(self) -> None:
        """Stop the worker processes (a later pass starts new ones)."""
        loader, self._loader = self._loader, None
        workers = getattr(loader, "_iterator", None)
        if workers is not None:
            workers._shutdown_workers()


def make_grain_loader(
    dataset: Any,
    batch_size: int,
    shuffle: bool = False,
    num_epochs: Optional[int] = None,
    seed: int = 0,
    num_workers: int = 0,
    drop_remainder: bool = True,
    shard: Optional[Tuple[int, int]] = None,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """An iterator of `num_epochs` epochs (None: without end) of stacked
    numpy batches, epoch k in the order of (seed, k); the dataset's own
    epoch is left as it is. The workers stop when the iterator is exhausted
    or closed."""
    loader = GrainLoader(dataset, batch_size, shuffle=shuffle, drop_last=drop_remainder,
                         num_workers=num_workers, seed=seed, shard=shard)

    def epochs():
        try:
            for k in itertools.count() if num_epochs is None else range(num_epochs):
                loader._epoch = k
                yield from loader
        finally:
            loader.close()

    return epochs()
