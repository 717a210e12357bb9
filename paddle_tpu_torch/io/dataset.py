"""Dataset types (``paddle_tpu/io/dataset.py``).

reference parity: python/paddle/fluid/dataloader/dataset.py (Dataset,
IterableDataset, TensorDataset, ComposeDataset, ChainDataset, ConcatDataset,
Subset, random_split). Host-side and device-free: a ``TensorDataset``
keeps host numpy copies of its tensors (bf16 as f32, every value exact),
and ``random_split`` draws ``generator.host_rng()``, the JAX package's
permutation for the same ``paddle.seed``.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np

from ..tensor import Tensor

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
]


class Dataset:
    """Map-style dataset (reference: dataloader/dataset.py Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __getitem__"
        )

    def __len__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __len__"
        )


class IterableDataset(Dataset):
    """Stream-style dataset (reference: dataloader/dataset.py
    IterableDataset)."""

    def __iter__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __iter__"
        )

    def __getitem__(self, idx):
        raise TypeError("IterableDataset does not support indexing")

    def __len__(self):
        # TypeError (not RuntimeError) so list(ds) treats it as "no length
        # hint" instead of propagating
        raise TypeError("IterableDataset does not support len()")


class TensorDataset(Dataset):
    """Wraps equal-first-dim tensors; item i is the tuple of row i."""

    def __init__(self, tensors: Sequence):
        arrays = []
        for t in tensors:
            if isinstance(t, Tensor):
                arrays.append(t.numpy())
            else:
                arrays.append(np.asarray(t))
        n = arrays[0].shape[0]
        for a in arrays:
            assert a.shape[0] == n, "tensors must share dim 0 size"
        self._arrays = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self._arrays)

    def __len__(self):
        return self._arrays[0].shape[0]


class ComposeDataset(Dataset):
    """Zip of same-length datasets; fields concatenated."""

    def __init__(self, datasets: Sequence[Dataset]):
        assert datasets, "datasets must not be empty"
        self._datasets = list(datasets)
        n = len(self._datasets[0])
        for d in self._datasets:
            assert len(d) == n, "datasets must share length"

    def __len__(self):
        return len(self._datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self._datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    """Concatenation of iterable datasets."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self._datasets = list(datasets)

    def __iter__(self):
        for d in self._datasets:
            yield from d


class ConcatDataset(Dataset):
    """Concatenation of map-style datasets."""

    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        assert self.datasets, "datasets must not be empty"
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None) -> List[Subset]:
    """reference: dataloader/dataset.py random_split (supports fractions)."""
    if all(isinstance(l, float) for l in lengths):
        if abs(sum(lengths) - 1.0) > 1e-6:
            raise ValueError(
                f"Fractional lengths must sum to 1, got {sum(lengths)}"
            )
        total = len(dataset)
        counts = [int(np.floor(total * f)) for f in lengths]
        rem = total - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != len(dataset):
        raise ValueError(
            "Sum of input lengths does not equal the length of the input dataset!"
        )
    from ..generator import host_rng

    perm = host_rng().permutation(len(dataset)).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out
