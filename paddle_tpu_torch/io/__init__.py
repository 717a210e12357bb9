"""paddle_tpu_torch.io: datasets, samplers, DataLoader (``paddle_tpu/io``).

reference parity: paddle.io (python/paddle/io/, fluid/reader.py:311,
fluid/dataloader/). Host-side and device-free: batches are Tensors on
the CPU. The process and shared-memory workers and
``get_worker_info`` are not ported yet (ROADMAP Queue 1C item 13(b)).
"""
from .dataloader import DataLoader, default_collate_fn
from .dataset import (
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)

__all__ = [
    "DataLoader", "default_collate_fn",
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "SubsetRandomSampler",
    "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
]
