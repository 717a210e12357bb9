"""``paddle_tpu_torch.io`` against ``paddle_tpu.io``, on the CPU, exact.

- Every sampler's order equals the JAX package's for the same
  ``paddle.seed``, epoch and tag (``RandomSampler`` with and without
  replacement and free-running, ``SubsetRandomSampler``,
  ``WeightedRandomSampler``, ``BatchSampler``, ``DistributedBatchSampler``
  over ranks), and so does ``random_split``.
- ``DataLoader`` batches equal across packages (shuffled, ``drop_last``,
  two prefetch threads, dict and tuple samples), as CPU Tensors.
- The position is sample-exact: ``state_dict`` taken mid-epoch and
  ``set_state_dict`` on a fresh loader serve the same remaining batches
  in both packages; ``advance_batches`` skips as the JAX loader does; an
  ``IterableDataset`` resumes by consuming.
- ``torch.Generator.seed()`` (which reseeds from a non-deterministic
  source) is never called: the port's global generator is swapped for a
  proxy that raises on it, and its state is the same after the loaders
  ran.
- The dataset classes give the JAX package's items.
- ``worker_mode="process"`` raises ``NotImplementedError`` naming its
  ROADMAP item.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.io as jio
import paddle_tpu_torch as paddle
import paddle_tpu_torch.io as tio
from paddle_tpu_torch import generator
from torch_facade_common import on_cpu  # noqa: F401 (autouse)

SIDES = ((pt, jio), (paddle, tio))


def _both(fn):
    out = []
    for P, io in SIDES:
        P.seed(1234)
        out.append(fn(P, io))
    assert out[0] == out[1], out
    return out[1]


class _Squares:
    def __init__(self, io, n=23):
        class DS(io.Dataset):
            def __len__(self):
                return n

            def __getitem__(self, i):
                return (np.float32([i, i * i]), np.int64(i % 3))
        self.ds = DS()


def _np(x):
    return np.asarray(x.numpy()).tolist()


@pytest.mark.parametrize("epoch", [None, 0, 3])
def test_random_sampler_orders_match(epoch):
    def run(P, io):
        outs = []
        for kw in ({}, {"replacement": True, "num_samples": 30},
                   {"num_samples": 7}):
            s = io.RandomSampler(list(range(19)), **kw)
            if epoch is not None:
                s.set_epoch(epoch)
            outs.append(list(s))
            outs.append(list(s))  # a second pass: the next stream
        return outs
    out = _both(run)
    assert sorted(out[0]) == list(range(19))


def test_subset_weighted_and_batch_samplers_match():
    def run(P, io):
        sub = io.SubsetRandomSampler([3, 9, 4, 11, 2])
        sub.set_epoch(2)
        w = io.WeightedRandomSampler([0.1, 0.5, 0.2, 0.2], num_samples=12)
        w.set_epoch(5)
        w2 = io.WeightedRandomSampler([1, 2, 3, 4, 5], num_samples=4,
                                      replacement=False)
        b = io.BatchSampler(list(range(10)), shuffle=True, batch_size=3)
        b.set_epoch(1)
        seq = io.BatchSampler(list(range(7)), batch_size=3, drop_last=True)
        return [list(sub), list(w), list(w2), list(b), list(seq), len(b),
                len(seq)]
    _both(run)


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_matches(shuffle):
    def run(P, io):
        out = []
        for rank in range(3):
            s = io.DistributedBatchSampler(list(range(10)), batch_size=2,
                                           num_replicas=3, rank=rank,
                                           shuffle=shuffle)
            s.set_epoch(4)
            out.append((list(s), list(s), len(s)))
        return out
    _both(run)


def test_random_split_matches():
    def run(P, io):
        ds = io.TensorDataset([np.arange(10)])
        parts = io.random_split(ds, [0.5, 0.3, 0.2])
        again = io.random_split(ds, [4, 6])
        return [[int(p[i][0]) for i in range(len(p))]
                for p in parts + again]
    _both(run)


@pytest.mark.parametrize("kw", [
    {"batch_size": 4, "shuffle": True},
    {"batch_size": 5, "shuffle": True, "drop_last": True},
    {"batch_size": 4, "shuffle": True, "num_workers": 2}],
    ids=["shuffle", "drop_last", "threads"])
def test_dataloader_batches_match(kw):
    def run(P, io):
        loader = io.DataLoader(_Squares(io).ds, **kw)
        epochs = []
        for _ in range(2):
            epochs.append([(_np(x), _np(y)) for x, y in loader])
        return epochs, len(loader)
    epochs, _n = _both(run)
    assert epochs[0] != epochs[1]  # each epoch its own order
    x, _y = next(iter(tio.DataLoader(_Squares(tio).ds, **kw)))
    assert isinstance(x, paddle.Tensor) and x.place == "cpu"
    assert x._value.dtype == torch.float32


def test_collate_of_dicts_tensors_and_strings():
    class DS(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return {"t": paddle.to_tensor(np.float32([i])), "s": f"r{i}",
                    "n": float(i)}
    b = next(iter(tio.DataLoader(DS(), batch_size=4)))
    assert b["s"] == ["r0", "r1", "r2", "r3"]
    assert _np(b["t"]) == [[0.0], [1.0], [2.0], [3.0]] and \
        b["t"].place == "cpu"
    assert _np(b["n"]) == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("workers", [0, 2])
def test_state_dict_resume_is_sample_exact(workers):
    def run(P, io):
        kw = dict(batch_size=3, shuffle=True, num_workers=workers)
        loader = io.DataLoader(_Squares(io).ds, **kw)
        loader.set_epoch(2)
        it = iter(loader)
        seen = [_np(next(it)[0]) for _ in range(3)]
        pos = loader.state_dict()
        rest = [_np(x) for x, _ in it]
        fresh = io.DataLoader(_Squares(io).ds, **kw)
        fresh.set_state_dict(pos)
        resumed = [_np(x) for x, _ in fresh]
        skipper = io.DataLoader(_Squares(io).ds, **kw)
        skipper.set_state_dict(pos)
        skipper.advance_batches(2)
        skipped = [_np(x) for x, _ in skipper]
        return seen, pos, rest, resumed, skipped, fresh.state_dict()
    seen, pos, rest, resumed, skipped, after = _both(run)
    assert pos == {"epoch": 2, "batch": 3, "sample": 9}
    assert resumed == rest and skipped == rest[2:]
    assert after == {"epoch": 3, "batch": 0, "sample": 0}


def test_iterable_dataset_resumes_by_consuming():
    def run(P, io):
        class Stream(io.IterableDataset):
            def __iter__(self):
                return iter(np.arange(11, dtype=np.float32))
        loader = io.DataLoader(Stream(), batch_size=3)
        it = iter(loader)
        next(it)
        pos = loader.state_dict()
        fresh = io.DataLoader(Stream(), batch_size=3)
        fresh.set_state_dict(pos)
        return pos, [_np(b) for b in fresh]
    pos, rest = _both(run)
    assert pos["batch"] == 1 and rest[0] == [3.0, 4.0, 5.0]


class _NoReseed:
    """The global generator with ``seed()`` refused."""

    def __init__(self, gen):
        self._gen = gen

    def seed(self):
        raise AssertionError("torch.Generator.seed() reseeds from a "
                             "non-deterministic source")

    def __getattr__(self, name):
        return getattr(self._gen, name)


def test_the_torch_generator_is_never_reseeded(monkeypatch):
    paddle.seed(77)
    state = generator.default_generator.get_state()
    monkeypatch.setattr(generator, "default_generator",
                        _NoReseed(generator.default_generator))
    loader = tio.DataLoader(_Squares(tio).ds, batch_size=4, shuffle=True)
    for _ in range(2):
        list(loader)
    tio.random_split(_Squares(tio).ds, [0.5, 0.5])
    list(tio.WeightedRandomSampler([1, 2], num_samples=3))
    assert generator.initial_seed() == 77
    assert torch.equal(generator.default_generator.get_state(), state)


def test_dataset_classes_match():
    def run(P, io):
        a = io.TensorDataset([np.arange(6).reshape(3, 2),
                              np.array([7, 8, 9])])
        comp = io.ComposeDataset([a, io.TensorDataset([np.ones(3)])])
        cat = io.ConcatDataset([a, a])
        sub = io.Subset(cat, [5, 0, 3])

        class It(io.IterableDataset):
            def __init__(self, k):
                self.k = k

            def __iter__(self):
                return iter(range(self.k))
        chain = io.ChainDataset([It(2), It(3)])

        def items(ds):
            return [[np.asarray(v).tolist() for v in ds[i]]
                    for i in range(len(ds))]
        return (items(a), items(comp), items(cat), items(sub), cat[-1][1],
                list(chain), len(cat))
    _both(run)


def test_process_workers_wait_for_their_roadmap_item():
    """Their roadmap item (Queue 1C 13(b)) is done: a process-worker
    loader is built without a raise (its batches are held in
    tests/test_torch_io_workers.py), and an unknown mode is refused."""
    loader = tio.DataLoader(_Squares(tio).ds, num_workers=2,
                            worker_mode="process")
    assert (loader.worker_mode, loader.num_workers) == ("process", 2)
    with pytest.raises(ValueError, match="worker_mode"):
        tio.DataLoader(_Squares(tio).ds, worker_mode="fiber")
