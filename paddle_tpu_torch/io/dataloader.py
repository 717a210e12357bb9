"""DataLoader (``paddle_tpu/io/dataloader.py``).

reference parity: python/paddle/io.DataLoader (fluid/reader.py:311) and
fluid/dataloader/dataloader_iter.py. ``num_workers=0`` is synchronous;
``num_workers > 0`` assembles batches on a pool of prefetch threads
feeding a bounded, ordered queue (numpy slicing releases the GIL), or,
with ``worker_mode="process"``, in worker processes (the spawn context of
``torch.multiprocessing``): each takes batch indices from one queue,
fetches and collates them and puts the batch on the channel of
``io/shm_channel.py`` (shared-memory tensors with ``use_shared_memory``),
and the trainer hands them out in order, at most ``prefetch_factor x
num_workers`` in flight. A worker's exception is raised in the trainer
(its own type, the worker's traceback attached), and a worker that dies
ends the epoch with a ``RuntimeError``; ``get_worker_info`` answers in a
worker.
Collation yields this package's Tensors on the CPU: the train loop moves
a batch to its device (``hapi.Model`` moves it to the network's).

The position is sample-exact, as there: ``state_dict()`` is ``{"epoch",
"batch", "sample"}`` as consumed (not prefetched), ``set_state_dict``
makes the next ``__iter__`` replay that epoch's order (epoch-seeded
shuffling, ``set_epoch``) and skip the consumed prefix, and
``advance_batches(n)`` queues a further skip (the train sentinel's
quarantine).

The position stays sample-exact with process workers: it counts the
batches handed out, not those in flight.
"""
from __future__ import annotations

import itertools
import threading
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from ..tensor import Tensor
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info",
           "WorkerInfo"]

# inside a process worker: its id, the worker count and the dataset
_process_worker_state: dict = {}


class WorkerInfo:
    """Identity of the current DataLoader worker (reference:
    fluid/dataloader/worker.py get_worker_info)."""

    def __init__(self, id: int, num_workers: int, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, "
                f"num_workers={self.num_workers})")


def get_worker_info():
    """Inside a process worker: this worker's (id, num_workers, dataset);
    in the main process: None (reference contract)."""
    st = _process_worker_state
    if "dataset" not in st:
        return None
    return WorkerInfo(st.get("worker_id", 0), st.get("num_workers", 1),
                      st.get("dataset"))


def _end_epoch_once(it):
    """Advance the loader's epoch exactly once per exhausted iterator, no
    matter how many times next() is re-called on it."""
    if not getattr(it, "_epoch_noted", False):
        it._epoch_noted = True
        it._loader._note_epoch_end()


def _cpu(arr: np.ndarray) -> Tensor:
    return Tensor(torch.from_numpy(np.ascontiguousarray(arr)))


def default_collate_fn(batch):
    """Stack samples into batch Tensors on the CPU (reference:
    fluid/dataloader/collate.py default_collate_fn)."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor(torch.stack([s._value.detach().cpu() for s in batch]))
    if isinstance(sample, np.ndarray):
        return _cpu(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return _cpu(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(group)) for group in transposed]
    raise TypeError(f"batch data must be tensor/ndarray/number/dict/list, got {type(sample)}")


class _SingleProcessIter:
    def __init__(self, loader: "DataLoader"):
        self._loader = loader
        # lazy: the sampler streams batch-by-batch (an epoch of a 100M
        # sample dataset must not materialize millions of index lists);
        # only the prefetch iterators need the whole list up front
        self._it = loader._epoch_index_iter()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            indices = next(self._it)
        except StopIteration:
            _end_epoch_once(self)
            raise
        batch = self._loader._fetch(indices)
        self._loader._note_batch(len(indices))
        return batch


class _ThreadedPrefetchIter:
    """Bounded-queue prefetch over worker threads; preserves batch order."""

    def __init__(self, loader: "DataLoader"):
        self._loader = loader
        self._indices = loader._epoch_indices()
        capacity = max(2, loader.prefetch_factor * loader.num_workers)
        self._results: dict = {}
        self._results_lock = threading.Condition()
        self._next_out = 0
        self._next_in = 0
        self._in_lock = threading.Lock()
        self._capacity = capacity
        self._shutdown = False
        self._workers = [
            threading.Thread(target=self._work, args=(wid,), daemon=True)
            for wid in range(loader.num_workers)
        ]
        for w in self._workers:
            w.start()

    def _work(self, worker_id: int):
        init_err = None
        try:
            if self._loader.worker_init_fn is not None:
                self._loader.worker_init_fn(worker_id)
        except Exception:
            # must not die silently: claim batches and deliver the error,
            # otherwise the consumer waits forever on the missing index
            init_err = traceback.format_exc()
        while True:
            with self._in_lock:
                i = self._next_in
                if i >= len(self._indices):
                    return
                self._next_in += 1
            if init_err is not None:
                payload = (i, None, init_err)
            else:
                try:
                    batch = self._loader._fetch(self._indices[i])
                    payload = (i, batch, None)
                except Exception:  # propagate to consumer
                    payload = (i, None, traceback.format_exc())
            with self._results_lock:
                while (not self._shutdown and
                       i - self._next_out >= self._capacity):
                    self._results_lock.wait(0.1)
                if self._shutdown:
                    return
                self._results[i] = payload
                self._results_lock.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_out >= len(self._indices):
            self.close()
            _end_epoch_once(self)
            raise StopIteration
        with self._results_lock:
            while self._next_out not in self._results:
                self._results_lock.wait()
            i, batch, err = self._results.pop(self._next_out)
            self._next_out += 1
            self._results_lock.notify_all()
        if err is not None:
            self.close()
            raise RuntimeError(f"DataLoader worker failed:\n{err}")
        self._loader._note_batch(len(self._indices[i]))
        return batch

    def close(self):
        with self._results_lock:
            self._shutdown = True
            self._results_lock.notify_all()

    def __del__(self):
        self.close()


def _worker_loop(dataset, collate_fn, init_fn, worker_id: int,
                 num_workers: int, index_queue, channel, shared: bool):
    """A process worker: batches of indices in, packed batches out, until
    a None."""
    import torch

    from . import shm_channel

    torch.set_num_threads(1)
    _process_worker_state.update(dataset=dataset, worker_id=worker_id,
                                 num_workers=num_workers)
    collate = collate_fn or default_collate_fn
    try:
        if init_fn is not None:
            init_fn(worker_id)
        failure = None
    except Exception as e:
        failure = shm_channel.WorkerFailure(e, traceback.format_exc())
    while True:
        item = index_queue.get()
        if item is None:
            return
        seq, indices = item
        if failure is not None:
            channel.put((seq, failure))
            continue
        try:
            batch = collate([dataset[i] for i in indices])
            channel.put((seq, shm_channel.pack(batch, shared)))
        except Exception as e:
            channel.put((seq, shm_channel.WorkerFailure(
                e, traceback.format_exc())))


class _ProcessWorkersIter:
    """Process workers feeding an ordered channel (module docstring)."""

    def __init__(self, loader: "DataLoader"):
        import torch.multiprocessing as mp

        from .shm_channel import ShmChannel

        self._loader = loader
        self._workers = []
        self._channel = None
        self._indices = loader._epoch_indices()
        self._capacity = max(2, loader.prefetch_factor * loader.num_workers)
        self._next_submit = 0
        self._next_seq = 0
        self._stash = {}
        try:
            ctx = mp.get_context("spawn")
            self._channel = ShmChannel(ctx)
            self._index_queue = ctx.Queue()
            for wid in range(loader.num_workers):
                p = ctx.Process(
                    target=_worker_loop, daemon=True,
                    args=(loader.dataset, loader.collate_fn,
                          loader.worker_init_fn, wid, loader.num_workers,
                          self._index_queue, self._channel,
                          loader.use_shared_memory))
                p.start()
                self._workers.append(p)
            self._fill()
        except Exception:
            self.close()
            raise

    def _fill(self):
        while (self._next_submit < len(self._indices)
               and self._next_submit - self._next_seq < self._capacity):
            self._index_queue.put((self._next_submit,
                                   self._indices[self._next_submit]))
            self._next_submit += 1

    def __iter__(self):
        return self

    def __next__(self):
        from .shm_channel import WorkerFailure, unpack

        if self._next_seq >= len(self._indices):
            self.close()
            _end_epoch_once(self)
            raise StopIteration
        want = self._next_seq
        while want not in self._stash:
            try:
                seq, payload = self._channel.get(timeout=1.0)
                self._stash[seq] = payload
            except TimeoutError:
                dead = [p.exitcode for p in self._workers
                        if p.exitcode not in (None, 0)]
                if dead:
                    self.close()
                    raise RuntimeError(
                        f"DataLoader worker process(es) exited with codes "
                        f"{dead} before batch {want}") from None
        payload = self._stash.pop(want)
        self._next_seq += 1
        if isinstance(payload, WorkerFailure):
            self.close()
            payload.reraise()
        self._fill()
        self._loader._note_batch(len(self._indices[want]))
        return unpack(payload)

    def close(self):
        workers, self._workers = self._workers, []
        for _ in workers:
            try:
                self._index_queue.put(None)
            except Exception:
                pass
        for p in workers:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
        chan, self._channel = self._channel, None
        if chan is not None:
            chan.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _IterableDatasetIter:
    def __init__(self, loader: "DataLoader"):
        self._loader = loader
        self._it = iter(loader.dataset)
        # resume for iterable datasets = skip-by-consume: the stream is
        # re-iterated from the top and the already-served prefix discarded
        # (sample-exact iff the iterable is deterministic); counters reset
        # to what this iterator actually skipped
        skip = loader._consume_resume_batches()
        loader._batches_served = loader._samples_served = 0
        for b in _chunks_consumed(self._it, skip, loader.batch_size,
                                  loader.drop_last):
            loader._batches_served += 1
            loader._samples_served += len(b)

    def __iter__(self):
        return self

    def __next__(self):
        batch = list(itertools.islice(self._it, self._loader.batch_size))
        if not batch:
            _end_epoch_once(self)
            raise StopIteration
        if self._loader.drop_last and len(batch) < self._loader.batch_size:
            _end_epoch_once(self)
            raise StopIteration
        collate = self._loader.collate_fn or default_collate_fn
        out = collate(batch)
        self._loader._note_batch(len(batch))
        return out


def _chunks_consumed(it, n_batches, batch_size, drop_last):
    """Pull (and discard) the first ``n_batches`` batches of an iterable
    stream, yielding them so the caller can count skipped samples."""
    for _ in range(n_batches):
        batch = list(itertools.islice(it, batch_size))
        if not batch or (drop_last and len(batch) < batch_size):
            return
        yield batch


class DataLoader:
    """reference: paddle.io.DataLoader (fluid/reader.py:311).

    Examples:
        >>> class Squares(paddle.io.Dataset):
        ...     def __len__(self):
        ...         return 8
        ...     def __getitem__(self, i):
        ...         return np.float32(i), np.float32(i * i)
        >>> loader = paddle.io.DataLoader(Squares(), batch_size=4)
        >>> xs, ys = next(iter(loader))
        >>> xs.shape
        [4]
    """

    def __init__(
        self,
        dataset: Dataset,
        feed_list=None,
        places=None,
        return_list: bool = True,
        batch_sampler: Optional[BatchSampler] = None,
        batch_size: Optional[int] = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 0,
        use_buffer_reader: bool = True,
        prefetch_factor: int = 2,
        use_shared_memory: bool = True,
        timeout: int = 0,
        worker_init_fn: Optional[Callable] = None,
        persistent_workers: bool = False,
        worker_mode: str = "thread",
    ):
        del feed_list, places, return_list  # static-graph-only args
        del use_buffer_reader, timeout, persistent_workers
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = bool(use_shared_memory)
        if worker_mode not in ("thread", "process"):
            raise ValueError("worker_mode must be 'thread' or 'process'")
        self.worker_mode = worker_mode
        self._is_iterable = isinstance(dataset, IterableDataset)
        self.drop_last = drop_last
        # checkpoint-resume position: epoch + batches/samples consumed this
        # epoch. _resume_batches is the pending skip
        # the NEXT __iter__ applies; counters advance as batches are
        # *consumed* (not prefetched), so state_dict() mid-epoch is exact.
        self._epoch = 0
        self._batches_served = 0
        self._samples_served = 0
        self._resume_batches = 0
        # epoch-driving (set_epoch per __iter__) applies only to a sampler
        # the loader built itself: a user-provided batch_sampler keeps full
        # control of its own epoch/shuffle stream (the reference pattern of
        # calling DistributedBatchSampler.set_epoch by hand every epoch)
        self._owns_batch_sampler = False
        if self._is_iterable:
            assert batch_sampler is None, (
                "batch_sampler is not supported for IterableDataset"
            )
            self.batch_size = batch_size or 1
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            assert batch_size is not None and batch_size > 0
            self.batch_size = batch_size
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self._owns_batch_sampler = True

    def _fetch(self, indices):
        samples = [self.dataset[i] for i in indices]
        collate = self.collate_fn or default_collate_fn
        return collate(samples)

    # ------------------------------------------------- checkpoint resume
    def set_epoch(self, epoch: int):
        """Pin the epoch (shuffle stream + resume bookkeeping). Called
        automatically at each __iter__; call manually to replay or skip
        epochs. Epoch-seeded shuffling means the same (global seed, epoch)
        always yields the same batch order — the property checkpoint
        resume needs."""
        self._epoch = int(epoch)

    def state_dict(self) -> dict:
        """Exact stream position: epoch + batches/samples consumed within
        it. Goes inside a checkpoint (see paddle_tpu_torch.checkpoint
        capture_train_state) so resume continues from the next sample."""
        return {"epoch": self._epoch, "batch": self._batches_served,
                "sample": self._samples_served}

    def set_state_dict(self, state: dict):
        """Resume from a :meth:`state_dict` position: the next __iter__
        replays the saved epoch's order and skips the already-consumed
        prefix, so the first batch served is exactly the one the
        interrupted run would have seen next."""
        self._epoch = int(state.get("epoch", 0))
        self._batches_served = int(state.get("batch", 0))
        self._samples_served = int(state.get("sample", 0))
        self._resume_batches = self._batches_served

    load_state_dict = set_state_dict

    def advance_batches(self, n: int):
        """Queue ``n`` ADDITIONAL batches to skip at the next
        ``__iter__``, on top of any pending resume position — the train
        sentinel's rollback primitive: restore the last-known-good
        position via :meth:`set_state_dict`, then advance past the
        quarantined window so the replay deterministically trains only on
        the batches a clean run would have (``faults.sentinel``). A skip running past the epoch's end
        simply ends the epoch (quarantine clamps at the boundary)."""
        n = int(n)
        if n < 0:
            raise ValueError(f"advance_batches needs n >= 0, got {n}")
        self._resume_batches += n

    def _epoch_index_iter(self):
        """Lazy batch-index stream for the current epoch, the resume skip
        already consumed. The newest iterator owns the position: counters
        reset to its start offset, so an abandoned mid-epoch iterator
        can't leave stale batch/sample counts behind in state_dict()."""
        if self._owns_batch_sampler and hasattr(
                self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(self._epoch)
        it = iter(self.batch_sampler)
        skip = self._consume_resume_batches()
        served = samples = 0
        for b in itertools.islice(it, skip):
            served += 1
            samples += len(b)
        self._batches_served = served
        self._samples_served = samples
        return it

    def _epoch_indices(self):
        """Materialized form of :meth:`_epoch_index_iter` for the prefetch
        iterators, which need random access for ordered multi-worker
        scheduling."""
        return list(self._epoch_index_iter())

    def _consume_resume_batches(self) -> int:
        skip, self._resume_batches = self._resume_batches, 0
        return skip

    def _note_batch(self, n_samples: int):
        self._batches_served += 1
        self._samples_served += int(n_samples)

    def _note_epoch_end(self):
        self._epoch += 1
        self._batches_served = 0
        self._samples_served = 0
        self._resume_batches = 0

    def __iter__(self):
        if self._is_iterable:
            return _IterableDatasetIter(self)
        if self.num_workers > 0 and self.worker_mode == "process":
            return _ProcessWorkersIter(self)
        if self.num_workers > 0:
            return _ThreadedPrefetchIter(self)
        return _SingleProcessIter(self)

    def __len__(self):
        if self._is_iterable:
            raise TypeError("length of IterableDataset loader is unknown")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()
