"""paddle_tpu_torch.io: datasets, samplers, DataLoader (``paddle_tpu/io``).

reference parity: paddle.io (python/paddle/io/, fluid/reader.py:311,
fluid/dataloader/). Host-side and device-free: batches are Tensors on
the CPU, made by the caller's thread, by worker threads or by worker
processes (``worker_mode="process"``, whose batches travel as
shared-memory tensors, ``io/shm_channel.py``).
"""
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info)
from .dataset import (
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)

__all__ = [
    "DataLoader", "default_collate_fn", "get_worker_info", "WorkerInfo",
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "SubsetRandomSampler",
    "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
]
