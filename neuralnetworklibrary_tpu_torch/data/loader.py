"""Host-side data loading with static batch shapes (numpy).

A copy of ``neuralnetworklibrary_tpu/data/loader.py``, kept here because
the port imports nothing of the JAX package:

- every batch has exactly ``bs`` rows; the final short batch is padded by
  repeating its last valid row and carries a float mask and the valid
  count (the Learner rescales lr by ``n_valid/bs``);
- shuffling uses a seeded ``np.random.Generator`` re-keyed per epoch;
- batches are collated on a background thread.

Not ported yet: multi-host sharding (``host_shard``), the fetch thread
pool (``num_workers``), batch ``transform`` and per-sample rngs
(``getitem_rng``).  The Learner copies each batch to the card itself.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from neuralnetworklibrary_tpu_torch.utils import tracing


@dataclass
class Batch:
    """One fixed-shape minibatch: ``xs`` is always a tuple of arrays."""

    xs: tuple
    y: Any
    mask: np.ndarray  # (bs,) float32, 1 for valid rows
    n_valid: int


class ArrayDataset:
    """Dataset over pre-built arrays: item i is ``(arrays[0][i], ...,
    arrays[-1][i])``.  The last array is the target; the rest are inputs."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("all arrays must have equal length")
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)


def default_collate(samples: Sequence[tuple]) -> tuple:
    """Stack a list of per-sample tuples into a tuple of batched arrays."""
    return tuple(np.stack([s[i] for s in samples])
                 for i in range(len(samples[0])))


class DataLoader:
    """Minibatch iterator over a dataset of (x..., y) tuples.

    Every batch has exactly ``bs`` rows (the final short batch padded and
    masked).  ``len()`` is the number of batches per epoch.  Iteration
    advances an epoch counter, so each epoch reshuffles deterministically.
    """

    def __init__(self, dataset, bs: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 collate: Callable = default_collate, prefetch: int = 2):
        self.dataset = dataset
        self.bs = bs
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate = collate
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def peek(self) -> Batch:
        """First batch in natural order, without advancing the epoch."""
        return self._make_batch(np.arange(min(self.bs, len(self.dataset))))

    def _epoch_indices(self) -> np.ndarray:
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idxs)
        return idxs

    def _make_batch(self, idxs: np.ndarray) -> Batch:
        n_valid = len(idxs)
        if n_valid < self.bs:  # pad by repeating the last valid row
            idxs = np.concatenate([idxs, np.full(self.bs - n_valid,
                                                 idxs[-1])])
        fields = self.collate([self.dataset[int(i)] for i in idxs])
        mask = np.zeros(self.bs, np.float32)
        mask[:n_valid] = 1.0
        return Batch(xs=tuple(fields[:-1]), y=fields[-1], mask=mask,
                     n_valid=n_valid)

    def _iter_batches(self) -> Iterator[Batch]:
        idxs = self._epoch_indices()
        n_batches = len(self)
        for b in range(n_batches):
            yield self._make_batch(idxs[b * self.bs:(b + 1) * self.bs])
        self.epoch += 1

    def __iter__(self) -> Iterator[Batch]:
        it = self._iter_batches()
        if self.prefetch and self.prefetch > 0:
            it = _prefetched(it, self.prefetch)
        return _spanned(it)


def _spanned(it: Iterator) -> Iterator:
    """``it``, each item's making (or wait on the prefetch queue) in a
    ``loader.next`` span on the consumer's thread."""
    end = object()
    while True:
        with tracing.span("loader.next"):
            item = next(it, end)
        if item is end:
            return
        yield item


def _prefetched(it: Iterator, size: int) -> Iterator:
    """Run ``it`` on a daemon thread, buffering up to ``size`` items."""
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(end)
        except BaseException as e:  # handed to the consumer, which raises
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
