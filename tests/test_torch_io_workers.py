"""The DataLoader's process workers (``worker_mode="process"``, with and
without shared memory) against its thread workers and the JAX package's
loader, as ``tests/test_shm_dataloader.py:100-128`` holds the JAX
process workers: batches in order, a worker's exception raised in the
trainer, and the sample-exact resume position of
``state_dict``/``set_state_dict``. Each process loader starts two
workers (a few seconds each, importing torch)."""
import numpy as np
import pytest

from paddle_tpu_torch.io import DataLoader, get_worker_info
from torch_suite import one_torch_thread  # noqa: F401


class _SquareDataset:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        return np.full((4,), i * i, dtype=np.float32)


class _BadDataset(_SquareDataset):
    def __getitem__(self, i):
        if i == 9:
            raise ValueError("bad sample 9")
        return super().__getitem__(i)


class _WhoDataset(_SquareDataset):
    def __getitem__(self, i):
        info = get_worker_info()
        return np.array([i, -1 if info is None else info.num_workers],
                        dtype=np.int64)


def _rows(loader):
    return [b.numpy() for b in loader]


@pytest.mark.parametrize("shared", [True, False])
def test_process_workers_in_order_like_threads_and_jax(shared):
    from paddle_tpu.io import DataLoader as JaxLoader

    proc = _rows(DataLoader(_SquareDataset(), batch_size=4, num_workers=2,
                            worker_mode="process",
                            use_shared_memory=shared))
    thread = _rows(DataLoader(_SquareDataset(), batch_size=4, num_workers=2))
    jax = [np.asarray(b.numpy()) for b in JaxLoader(
        _SquareDataset(), batch_size=4, num_workers=2)]
    assert len(proc) == len(thread) == len(jax) == 8
    for p, t, j in zip(proc, thread, jax):
        assert p.shape == (4, 4)
        np.testing.assert_array_equal(p, t)
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(np.concatenate([p[:, 0] for p in proc]),
                                  (np.arange(32) ** 2).astype(np.float32))


def test_worker_exception_reaches_the_trainer():
    loader = DataLoader(_BadDataset(), batch_size=4, num_workers=2,
                        worker_mode="process")
    seen = []
    with pytest.raises(ValueError, match="bad sample 9"):
        for b in loader:
            seen.append(b.numpy()[:, 0])
    assert len(seen) == 2  # the batches before the bad one, in order
    with pytest.raises(RuntimeError, match="bad sample 9"):
        for _ in DataLoader(_BadDataset(), batch_size=4, num_workers=2):
            pass


def test_resume_position_is_sample_exact_like_threads():
    """Three batches consumed, the position saved, a new loader resumed
    from it: the rest of the epoch, as the thread workers give it, and
    the same positions in ``state_dict`` along the way."""
    def run(mode):
        first = DataLoader(_WhoDataset(), batch_size=4, num_workers=2,
                           worker_mode=mode, shuffle=True)
        first.set_epoch(1)
        it = iter(first)
        head = [next(it).numpy()[:, 0] for _ in range(3)]
        state = first.state_dict()
        it.close() if hasattr(it, "close") else None
        second = DataLoader(_WhoDataset(), batch_size=4, num_workers=2,
                            worker_mode=mode, shuffle=True)
        second.set_state_dict(state)
        rest = [b.numpy() for b in second]
        return head, state, rest, second.state_dict()

    ph, ps, pr, pend = run("process")
    th, ts, tr, tend = run("thread")
    assert ps == ts == {"epoch": 1, "batch": 3, "sample": 12}
    for a, b in zip(ph, th):
        np.testing.assert_array_equal(a, b)
    assert len(pr) == len(tr) == 5
    for a, b in zip(pr, tr):
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        assert (a[:, 1] == 2).all() and (b[:, 1] == -1).all()
    assert pend == tend == {"epoch": 2, "batch": 0, "sample": 0}
