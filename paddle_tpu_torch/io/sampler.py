"""Samplers (``paddle_tpu/io/sampler.py``).

reference parity: python/paddle/fluid/dataloader/sampler.py (Sampler,
SequenceSampler, RandomSampler, WeightedRandomSampler) and batch_sampler.py
(BatchSampler, DistributedBatchSampler). Every order is drawn from numpy
streams keyed by the seed ``paddle.seed`` set (``generator.initial_seed``,
never ``torch.Generator.seed()``, which would reseed the generator from
a non-deterministic source), so each sampler's order equals the JAX
package's index for index for the same seed, epoch and tag.
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..generator import host_rng, initial_seed

__all__ = [
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "SubsetRandomSampler",
]


def _epoch_rng(epoch, tag: int) -> np.random.Generator:
    """Epoch-deterministic RNG for randomized samplers whose epoch is
    pinned (checkpoint resume must replay the exact order). The per-class
    ``tag`` and the tuple shape give domain separation from host_rng()'s
    (seed, counter) space and from each other — two samplers sharing a
    seed and epoch must not draw in lockstep. epoch=None keeps the legacy
    free-running stream."""
    if epoch is None:
        return host_rng()
    return np.random.default_rng((initial_seed(), tag, epoch))


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source
        # set_epoch pins randomized samplers to an epoch-deterministic
        # stream — the contract checkpoint resume relies on: the same
        # (global seed, epoch) must yield the same order in both the
        # interrupted and the resumed run. None = legacy free-running RNG.
        self.epoch: Optional[int] = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        # reference: sampler.py rejects oversampling without replacement at
        # construction — failing here keeps __len__ honest for DataLoader
        # sizing instead of blowing up mid-epoch
        if (not replacement and num_samples is not None
                and generator is None and num_samples > len(data_source)):
            raise ValueError(
                "RandomSampler: num_samples should not exceed dataset "
                "length when replacement=False")
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.generator is not None:
            # bounded to num_samples (an unbounded generator must not make
            # the epoch infinite)
            yield from (int(i) for i in
                        itertools.islice(self.generator, self.num_samples))
            return
        rng = _epoch_rng(self.epoch, 0x5EED)
        if self.replacement:
            yield from rng.integers(0, n, size=self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices: Sequence[int]):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        rng = _epoch_rng(self.epoch, 0x5EEE)
        yield from (self.indices[i] for i in rng.permutation(len(self.indices)))

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights: Sequence[float], num_samples: int,
                 replacement: bool = True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        if num_samples <= 0:
            raise ValueError("num_samples should be a positive integer")
        if not replacement and num_samples > len(self.weights):
            raise ValueError(
                "num_samples should not be larger than weights length when "
                "replacement is False"
            )
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = _epoch_rng(self.epoch, 0x5EEF)
        idx = rng.choice(len(p), size=self.num_samples, replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """reference: dataloader/batch_sampler.py BatchSampler."""

    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        super().__init__(dataset)
        if sampler is not None:
            assert dataset is None, "either dataset or sampler, not both"
            self.sampler = sampler
        else:
            assert dataset is not None, "either dataset or sampler must be given"
            self.sampler = (
                RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
            )
        assert batch_size > 0, "batch_size should be a positive integer"
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle

    def set_epoch(self, epoch: int) -> None:
        """Forwarded to the wrapped sampler: makes a shuffled epoch
        deterministic given (global seed, epoch) — checkpoint resume
        replays the exact same batch order."""
        super().set_epoch(epoch)
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards batches across data-parallel ranks (reference:
    python/paddle/fluid/dataloader/batch_sampler.py DistributedBatchSampler).

    The rank and world size default to ``distributed.get_rank()`` and
    ``get_world_size()`` (the environment's, or an initialized process
    group's)."""

    def __init__(self, dataset, batch_size: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = False,
                 drop_last: bool = False):
        self.dataset = dataset
        assert batch_size > 0
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        if num_replicas is None or rank is None:
            from .. import distributed as dist

            num_replicas = num_replicas if num_replicas is not None else dist.get_world_size()
            rank = rank if rank is not None else dist.get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        # pad to be evenly divisible; cycle when total_size - n > n
        # (tiny dataset over many replicas)
        while len(indices) < self.total_size:
            indices += indices[: (self.total_size - len(indices))]
        # subsample for this rank
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
