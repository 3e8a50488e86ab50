"""Length-bucketed batch sampling; the port's copy of
roar_tpu/data/sampling.py `LengthBucketBatchSampler` (host code, numpy: the
same seed, epoch and lengths give the same batches in the same order)."""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


class LengthBucketBatchSampler:
    """Yields lists of dataset indices.

    Items are sorted by length, grouped into contiguous batches (so lengths
    within a batch are similar), and the batch order is shuffled per epoch.
    With `num_shards`, each shard sees a disjoint, equally sized subset of
    the batches (drop-last across shards).
    """

    def __init__(
        self,
        lengths: Sequence[float],
        batch_size: int,
        num_shards: int = 1,
        shard_rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        boundaries: Optional[Sequence[float]] = None,
    ):
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_rank = shard_rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.boundaries = boundaries
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> List[np.ndarray]:
        rng = np.random.default_rng((self.seed, self.epoch))
        order = np.argsort(self.lengths, kind="stable")
        if self.shuffle:
            # jitter within the length-sorted order: shuffle inside coarse blocks
            block = max(self.batch_size * 8, 1)
            blocks = [order[i : i + block] for i in range(0, len(order), block)]
            order = np.concatenate([rng.permutation(b) for b in blocks]) if blocks else order
        bs = self.batch_size
        n_full = len(order) // bs
        batches = [order[i * bs : (i + 1) * bs] for i in range(n_full)]
        if not self.drop_last and len(order) % bs:
            batches.append(order[n_full * bs :])
        if self.shuffle:
            rng.shuffle(batches)
        if self.num_shards > 1:
            usable = (len(batches) // self.num_shards) * self.num_shards
            batches = batches[self.shard_rank : usable : self.num_shards]
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        for b in self._batches():
            yield [int(i) for i in b]

    def __len__(self) -> int:
        return len(self._batches())
