"""paddle_tpu_torch.checkpoint: crash-consistent checkpoints and resume
(``paddle_tpu/checkpoint``).

- :class:`CheckpointManager` (manager.py): a step-versioned directory
  with an atomic commit protocol (scratch directory, fsynced shard
  files, a COMMIT marker with per-file sizes and CRC32s written last,
  one atomic rename); ``restore()`` verifies and quarantines a corrupt
  step, falling back to the newest valid one; retention GC keeps the
  last K.
- ``save_on_signal()`` / ``restore_or_init()``: checkpoint-and-exit on
  SIGTERM, and one call to pick the run back up.
- ``capture_train_state`` / ``restore_train_state`` (state.py): params,
  optimizer state, this package's RNG state and the dataloader's
  position, so a resumed run is sample-exact (``tools/train_chaos.py``
  holds it to an uninterrupted run bit for bit).

The files underneath are ``distributed.checkpoint``'s, the JAX package's
format: a step either package commits, the other restores (its ``rng``
entry excepted, state.py).

    from paddle_tpu_torch import checkpoint

    mgr = checkpoint.CheckpointManager("/ckpts/run7", max_to_keep=3)
    res = mgr.restore_or_init()
    start = 0
    if res.restored:
        start = checkpoint.restore_train_state(
            res.state, model=net, optimizer=opt, dataloader=loader) + 1
    for step in range(start, total_steps):
        train_step(...)
        mgr.save(step, checkpoint.capture_train_state(..., step=step),
                 async_save=True)
    checkpoint.wait()   # async saves are durable only after this returns
"""
from ..distributed.checkpoint import AsyncHandle, CheckpointError, wait
from .manager import (CheckpointManager, CheckpointNotFoundError,
                      RestoreResult)
from .state import (capture_train_state, restore_train_state,
                    rng_state_dict, set_rng_state_dict)

__all__ = [
    "AsyncHandle", "CheckpointError", "CheckpointManager",
    "CheckpointNotFoundError", "RestoreResult", "capture_train_state",
    "restore_train_state", "rng_state_dict", "set_rng_state_dict", "wait",
]
