"""CheckpointManager: crash-consistent commit and auto-resume
(``paddle_tpu/checkpoint/manager.py``).

The commit protocol, as there:

1. every save targets a scratch directory ``step_<N>.tmp-<nonce>`` — never
   the published name;
2. shard files + the shard manifest land there via
   ``distributed.checkpoint.save_state_dict`` (each file fsynced, manifest
   last — see that module's ordering contract);
3. pure-python scalar leaves (epoch counters, dataloader offsets, LR
   scheduler floats) are split into ``scalars.json`` so they round-trip
   with exact types instead of as 0-d arrays;
4. a ``COMMIT`` marker carrying per-file sizes + CRC32s is written last
   (tmp + fsync + atomic replace), then the whole directory is atomically
   renamed to ``step_<N>`` and the parent directory fsynced.

A step therefore exists to readers *only* if every byte it references was
durable first. ``latest_step()`` never sees a partial save; ``restore()``
re-verifies the COMMIT checksums and quarantines any step that fails
(renamed ``corrupt-step_<N>-<nonce>``), falling back to the newest valid
step. Retention GC keeps the last ``max_to_keep`` committed steps.

Preemption: ``save_on_signal()`` installs SIGTERM/SIGINT handlers that
checkpoint synchronously and exit cleanly. The handler runs between two
Python bytecodes of the main thread: its snapshot's ``.cpu()`` copies
synchronize the card, and it must not fire inside a
``jit.StaticFunction`` capture (a capture may not synchronize): install
it around an eager loop, or around the replays, not around a first call.
Between any two bytecodes also means mid-step: after ``next(loader)`` and
before the update the state it captures is one batch apart. A loop that
must not be split blocks the signal in every thread and unblocks it
between steps (``tools/train_chaos.py``'s preemption child).
``restore_or_init()`` is the one-call resume entry point.

Restored tensors are made on the manager's ``device`` (the card unless
it is built with ``device="cpu"``); ``set_state_dict`` then copies them
into the live cells in place.

Fault points: ``ckpt.commit`` fires before the COMMIT-marker write and
again before the publish rename (``times=1`` kills the marker,
``times=1, after=1`` kills the rename); the write/fsync/manifest points
live in ``distributed.checkpoint``. Every phase is drilled by
``tools/train_chaos.py`` and ``tests/test_torch_checkpoint_manager.py``.

Several ranks (a ``torch.distributed`` job of more than one rank):
every rank writes its blocks (``distributed.checkpoint``: ZeRO's slices,
a pipeline stage's rows, DTensor blocks; replicated leaves by rank 0)
into ONE shared scratch directory, ``step_<N>.tmp-shared``, and only
process 0 commits, as the JAX manager does. At the start of a save
process 0 removes what a crashed save of the same step left in that
directory and the ranks meet (``torch.distributed.barrier``), so every
manifest found there afterwards is this save's. The barrier before the
commit is the other ranks' manifests: process 0 waits until
``checkpoint.metadata.json.p<r>`` of every rank r is in the scratch
directory (each rank writes its own last, after its shards), then writes
``scalars.json``, the COMMIT marker and renames. Process 0's COMMIT
digests cover the files it wrote itself, as in the JAX package.
``process_index`` defaults to the job's rank.
``restore(shardings=, target=)`` places each leaf as
``distributed.checkpoint.load_state_dict`` does. Six metrics live in
this package's registry: ``paddle_tpu_ckpt_save_seconds{mode}``,
``paddle_tpu_ckpt_last_committed_step``,
``paddle_tpu_ckpt_saves_total{result}``, ``paddle_tpu_ckpt_corrupt_total``,
``paddle_tpu_ckpt_restore_fallback_total`` and
``paddle_tpu_ckpt_gc_deleted_total``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal as _signal
import sys
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

from .. import faults, metrics
from ..device import resolve_device
from ..distributed import checkpoint as dist_ckpt
from ..distributed.checkpoint import (AsyncHandle, _atomic_json_write,
                                      _flatten, _unflatten)
from ..framework.io import _fsync_dir

__all__ = [
    "CheckpointManager", "CheckpointNotFoundError", "RestoreResult",
]

_COMMIT_FILE = "COMMIT"
_SCALARS_FILE = "scalars.json"
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_\d+\.tmp-")
_CORRUPT_PREFIX = "corrupt-"

# scratch dirs with an in-flight writer, process-wide: stale-tmp sweeping
# must never reap a LIVE async save's directory, including one started by
# a DIFFERENT CheckpointManager instance on the same directory (e.g. two
# successive Model.save_checkpoint calls each build their own manager)
_LIVE_TMP: set = set()
_LIVE_TMP_LOCK = threading.RLock()  # reentrant: see _pending_lock's note

_REG = metrics.get_registry()
_M_SAVE_SECONDS = _REG.histogram(
    "paddle_tpu_ckpt_save_seconds",
    "Checkpoint save wall time, snapshot through commit", labels=("mode",))
_M_LAST_STEP = _REG.gauge(
    "paddle_tpu_ckpt_last_committed_step",
    "Newest step whose COMMIT marker is published")
_M_SAVES = _REG.counter(
    "paddle_tpu_ckpt_saves_total",
    "Checkpoint save attempts by result", labels=("result",))
_M_CORRUPT = _REG.counter(
    "paddle_tpu_ckpt_corrupt_total",
    "Checkpoint steps quarantined after failing COMMIT verification")
_M_FALLBACK = _REG.counter(
    "paddle_tpu_ckpt_restore_fallback_total",
    "Restores that skipped a corrupt newest step for an older valid one")
_M_GC = _REG.counter(
    "paddle_tpu_ckpt_gc_deleted_total",
    "Committed steps deleted by retention GC")


class CheckpointNotFoundError(FileNotFoundError):
    """No committed (and verifiable) checkpoint step exists."""


class RestoreResult(NamedTuple):
    """What ``restore_or_init`` found: the state (or the caller's default),
    the committed step it came from (None when initializing fresh), and
    whether anything was restored."""

    state: Any
    step: Optional[int]
    restored: bool


def _step_name(step: int) -> str:
    return f"step_{step:08d}"


def _split_state(state: Dict) -> Tuple[Dict, Dict]:
    """Partition flat leaves into array-like (npy shard path) and pure
    python scalars (json path — exact int/float/bool/str/None round-trip,
    which sample-exact resume of epoch/offset counters depends on)."""
    arrays: Dict[str, Any] = {}
    scalars: Dict[str, Any] = {}
    for k, v in _flatten(state).items():
        if v is None or isinstance(v, (bool, int, float, str)):
            scalars[k] = v
        else:
            arrays[k] = v
    return arrays, scalars


def _drain_pending(timeout_s: float) -> None:
    """Best-effort bounded join of all outstanding async saves (signal
    handler use: never re-raise, never block past the budget — the
    post-drain ``all_steps()`` check decides what still needs saving)."""
    with dist_ckpt._pending_lock:
        pending = list(dist_ckpt._pending)
    deadline = time.monotonic() + max(0.0, timeout_s)
    for h in pending:
        t = h._thread
        if t is not None:
            t.join(max(0.0, deadline - time.monotonic()))


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def _fresh_shared(tmpdir: str, pidx: int) -> None:
    """The shared scratch made anew for this save: process 0 removes what
    a crashed save of the same step left there (its manifests among it)
    and every rank waits for it before writing (module docstring)."""
    import torch.distributed as dist

    if pidx == 0:
        shutil.rmtree(tmpdir, ignore_errors=True)
    dist.barrier()  # after it, no rank reaps or clears scratch
    os.makedirs(tmpdir, exist_ok=True)


def _await_manifests(tmpdir: str, world: int,
                     timeout_s: float = 600.0) -> None:
    """Process 0's barrier before a commit: every other rank's manifest
    in the shared scratch directory (module docstring)."""
    deadline = time.monotonic() + timeout_s
    names = [f"{dist_ckpt._META}.p{r}" for r in range(1, world)]
    while not all(os.path.isfile(os.path.join(tmpdir, n)) for n in names):
        if time.monotonic() > deadline:
            missing = [n for n in names
                       if not os.path.isfile(os.path.join(tmpdir, n))]
            raise TimeoutError(f"checkpoint commit: {missing} not in "
                               f"{tmpdir} after {timeout_s:.0f}s")
        time.sleep(0.01)


def _file_digest(path: str) -> Tuple[int, int]:
    """(size, crc32) streamed in 1 MiB chunks."""
    size, crc = 0, 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            size += len(chunk)
            crc = zlib.crc32(chunk, crc)
    return size, crc


class CheckpointManager:
    """Crash-consistent, step-versioned checkpoint directory.

    ::

        mgr = checkpoint.CheckpointManager(dir, max_to_keep=3)
        res = mgr.restore_or_init(default=init_state())
        for step in range(res.step + 1 if res.restored else 0, steps):
            train_step(...)
            mgr.save(step, capture_state(), async_save=True)
        checkpoint.wait()          # async saves durable only after this
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 5,
                 process_index: Optional[int] = None, device=None):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self._process_index = process_index
        # where restored tensors are made: the card unless told otherwise
        self.device = resolve_device(device)
        self.preempted = False  # set by the save_on_signal handler
        # serializes commit/GC phases; REENTRANT because the save_on_signal
        # handler runs on the main thread and may interrupt a save that is
        # inside its own locked commit — a plain Lock would self-deadlock
        self._save_lock = threading.RLock()
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------- steps
    def all_steps(self) -> list:
        """Committed steps (COMMIT marker present), ascending. Scratch
        ``.tmp-`` and quarantined ``corrupt-`` directories are invisible."""
        steps = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return steps
        for name in entries:
            m = _STEP_RE.match(name)
            if m and os.path.isfile(
                    os.path.join(self.directory, name, _COMMIT_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """Newest committed step, or None. Only ever sees directories whose
        COMMIT marker was published by the atomic rename."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, _step_name(step))

    # -------------------------------------------------------------- save
    def save(self, step: int, state: Dict, async_save: bool = False
             ) -> AsyncHandle:
        """Persist ``state`` (nested dict of Tensors/arrays/python scalars)
        as committed step ``step``.

        Sync: raises on any failure; on return the step is durable.
        Async: every tensor is copied to host memory before returning (the
        training loop writes its cells in place at the next step); commit
        happens on the writer thread and the returned handle's ``wait()``
        re-raises any failure — a step is durable only once ``wait()``
        returned cleanly.
        """
        step = int(step)
        if step < 0:
            raise ValueError(f"checkpoint step must be >= 0, got {step}")
        if step in set(self.all_steps()):
            raise ValueError(
                f"step {step} is already committed in {self.directory}; "
                f"checkpoint steps are immutable once published")
        self._clean_stale_tmp()
        arrays, scalars = _split_state(state)
        # several ranks: every one writes into ONE shared scratch name (a
        # nonce of its own would strand its shards in a directory the
        # commit never publishes) and process 0 commits
        world = _world_size()
        multi = world > 1
        pidx = (self._process_index if self._process_index is not None
                else dist_ckpt._process_index())
        nonce = "shared" if multi else os.urandom(4).hex()
        tmpdir = os.path.join(self.directory,
                              f"{_step_name(step)}.tmp-{nonce}")
        with _LIVE_TMP_LOCK:
            _LIVE_TMP.add(tmpdir)
        if multi:
            _fresh_shared(tmpdir, pidx)
        else:
            os.makedirs(tmpdir)
        t0 = time.perf_counter()
        mode = "async" if async_save else "sync"

        def finish(inner: AsyncHandle):
            try:
                inner.wait()  # re-raises the shard writer's failure
                if pidx != 0:
                    return  # workers publish shards only; process 0 commits
                if multi:
                    _await_manifests(tmpdir, world)
                digests = dict(inner.digests)
                digests[_SCALARS_FILE] = self._write_scalars(tmpdir, scalars)
                with self._commit_lock():
                    self._commit(tmpdir, step, digests)
                    _M_SAVE_SECONDS.labels(mode=mode).observe(
                        time.perf_counter() - t0)
                    # publish the DIRECTORY's latest, not this save's step:
                    # an out-of-order async commit (slow step 4 landing
                    # after step 5) must not walk the gauge backwards
                    _M_LAST_STEP.set(self.latest_step() or step)
                    _M_SAVES.labels(result="committed").inc()
                    self._gc()
            except BaseException:
                _M_SAVES.labels(result="failed").inc()
                raise
            finally:
                with _LIVE_TMP_LOCK:
                    _LIVE_TMP.discard(tmpdir)

        if async_save:
            # save_state_dict(async) copies the leaves to host on THIS
            # thread (may raise right here — device fetch, bad leaf);
            # the returned writer thread is then chained with the commit so
            # ordering (shards -> manifest -> COMMIT -> rename) holds end
            # to end.
            try:
                inner = dist_ckpt.save_state_dict(
                    arrays, tmpdir, async_save=True, process_index=pidx)
            except BaseException:
                _M_SAVES.labels(result="failed").inc()
                with _LIVE_TMP_LOCK:
                    _LIVE_TMP.discard(tmpdir)
                raise
            return dist_ckpt._spawn_async(lambda: finish(inner))

        try:
            inner = dist_ckpt.save_state_dict(
                arrays, tmpdir, async_save=False, process_index=pidx)
        except BaseException:
            _M_SAVES.labels(result="failed").inc()
            with _LIVE_TMP_LOCK:
                _LIVE_TMP.discard(tmpdir)
            raise
        finish(inner)
        return AsyncHandle(None)

    def save_if_absent(self, step: int, state: Dict,
                       async_save: bool = False) -> Optional[AsyncHandle]:
        """:meth:`save` unless ``step`` is already committed — returns
        None then, and tolerates losing a commit race (a concurrent save
        publishing the step IS durability). The idempotent path shared by
        the preemption signal handler and the train sentinel's
        mark/emergency saves, where "someone already committed this step"
        is success, not an error."""
        step = int(step)
        if step in set(self.all_steps()):
            return None
        try:
            return self.save(step, state, async_save=async_save)
        except ValueError:
            if step in set(self.all_steps()):
                return None
            raise

    def delete_step(self, step: int) -> bool:
        """Remove one committed step. For callers that own their step
        semantics beyond retention GC — the train sentinel prunes marks
        AHEAD of a resumed timeline (an epoch-granular restore rewound
        behind them; restoring such a mark would fast-forward params past
        the data stream). Returns False when the step isn't committed."""
        path = self.step_path(int(step))
        if not os.path.isfile(os.path.join(path, _COMMIT_FILE)):
            return False
        with self._commit_lock():
            shutil.rmtree(path, ignore_errors=True)
        # an rmtree failure (EBUSY/EPERM on a network fs) must not report
        # success: a caller pruning stale-timeline marks would otherwise
        # believe a restorable step is gone
        return not os.path.isfile(os.path.join(path, _COMMIT_FILE))

    @contextmanager
    def _commit_lock(self, timeout_s: float = 30.0):
        """Commit/GC serialization with a liveness escape hatch: if the
        holder is wedged past ``timeout_s`` (stuck I/O mid-commit), the
        caller proceeds unserialized with a warning — losing strict
        ordering beats losing the checkpoint entirely (the signal handler
        especially must outrun the preemption grace period). Distinct
        saves touch distinct scratch dirs; the rename-collision guard in
        _commit keeps even a same-step race loud and consistent."""
        got = self._save_lock.acquire(timeout=timeout_s)
        if not got:
            sys.stderr.write(
                f"[paddle_tpu_torch.checkpoint] commit lock not acquired "
                f"within {timeout_s}s (wedged save?); committing "
                f"unserialized\n")
        try:
            yield
        finally:
            if got:
                self._save_lock.release()

    def _write_scalars(self, dirpath: str, scalars: Dict) -> Dict[str, int]:
        faults.point("ckpt.write")
        return _atomic_json_write(os.path.join(dirpath, _SCALARS_FILE),
                                  scalars)

    def _commit(self, tmpdir: str, step: int,
                digests: Optional[Dict] = None) -> None:
        """COMMIT marker (sizes + CRC32s of every file already durable in
        the scratch dir) then the atomic publish rename. Digests normally
        arrive from the writers (accumulated as the bytes streamed out);
        the fallback re-reads the directory."""
        files = dict(digests) if digests else {}
        if not files:
            for name in sorted(os.listdir(tmpdir)):
                path = os.path.join(tmpdir, name)
                if name == _COMMIT_FILE or not os.path.isfile(path):
                    continue
                size, crc = _file_digest(path)
                files[name] = {"size": size, "crc32": crc}
        payload = {"step": step, "format": 1, "files": files}

        faults.point("ckpt.commit")  # phase 1: marker write
        _atomic_json_write(os.path.join(tmpdir, _COMMIT_FILE), payload)

        faults.point("ckpt.commit")  # phase 2: publish rename
        final = self.step_path(step)
        try:
            os.rename(tmpdir, final)
        except OSError:
            if os.path.isfile(os.path.join(final, _COMMIT_FILE)):
                # lost a commit race: a concurrent save (e.g. an async save
                # racing the signal handler) already published this step —
                # drop our duplicate scratch and report it clearly
                shutil.rmtree(tmpdir, ignore_errors=True)
                raise ValueError(
                    f"step {step} was committed concurrently by another "
                    f"save; this save's scratch was discarded") from None
            raise
        _fsync_dir(self.directory)

    def _clean_stale_tmp(self) -> None:
        """Remove scratch dirs a crashed PREVIOUS process left behind
        (single-writer directories by contract — see class docstring).
        In-flight async saves of THIS manager are exempt."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        with _LIVE_TMP_LOCK:
            live = set(_LIVE_TMP)
        latest = self.latest_step()
        for name in entries:
            path = os.path.join(self.directory, name)
            if not _TMP_RE.match(name) or path in live:
                continue
            if name.endswith(".tmp-shared"):
                # may be live in another rank: reaped only once a commit
                # has moved past its step (no rank can still write it)
                m = _STEP_RE.match(name.split(".tmp-")[0])
                if latest is None or (m and int(m.group(1)) > latest):
                    continue
            shutil.rmtree(path, ignore_errors=True)

    def _gc(self) -> None:
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(self.step_path(victim), ignore_errors=True)
            _M_GC.inc()

    # ----------------------------------------------------------- restore
    def verify(self, step: int) -> Tuple[bool, str]:
        """Re-check a committed step against its COMMIT record: every
        listed file must exist with matching size and CRC32."""
        return self._verify_dir(self.step_path(step))

    def _verify_dir(self, dirpath: str) -> Tuple[bool, str]:
        commit = os.path.join(dirpath, _COMMIT_FILE)
        try:
            with open(commit) as f:
                payload = json.load(f)
        except (OSError, ValueError) as exc:
            return False, f"unreadable COMMIT marker: {exc}"
        for name, rec in payload.get("files", {}).items():
            path = os.path.join(dirpath, name)
            if not os.path.isfile(path):
                return False, f"missing file {name!r}"
            size, crc = _file_digest(path)
            if size != rec.get("size"):
                return False, (f"size mismatch for {name!r}: "
                               f"{size} != {rec.get('size')}")
            if crc != rec.get("crc32"):
                return False, f"crc32 mismatch for {name!r}"
        return True, ""

    def _quarantine(self, step: int, reason: str) -> None:
        src = self.step_path(step)
        dst = os.path.join(
            self.directory,
            f"{_CORRUPT_PREFIX}{_step_name(step)}-{os.urandom(4).hex()}")
        try:
            os.rename(src, dst)
        except OSError:
            shutil.rmtree(src, ignore_errors=True)
        _M_CORRUPT.inc()
        sys.stderr.write(
            f"[paddle_tpu_torch.checkpoint] quarantined step {step} "
            f"({reason}) -> {dst}\n")

    def restore(self, step: Optional[int] = None,
                shardings: Optional[Dict] = None,
                target: Optional[Dict] = None) -> Tuple[Dict, int]:
        """Load a committed step (newest by default), verifying checksums.

        A step that fails verification is quarantined and the next-newest
        one tried; returns ``(state, step)`` or raises
        :class:`CheckpointNotFoundError` when nothing valid remains.
        ``shardings``/``target`` place each leaf as
        ``distributed.checkpoint.load_state_dict`` does."""
        steps = self.all_steps()
        if step is not None:
            if int(step) not in steps:
                raise CheckpointNotFoundError(
                    f"step {step} is not committed in {self.directory}")
            candidates = [int(step)]
        else:
            candidates = sorted(steps, reverse=True)
        fell_back = False
        for s in candidates:
            ok, reason = self._verify_dir(self.step_path(s))
            if not ok:
                self._quarantine(s, reason)
                fell_back = True
                continue
            state = self._load_dir(self.step_path(s), shardings, target)
            if fell_back:
                _M_FALLBACK.inc()
            return state, s
        raise CheckpointNotFoundError(
            f"no valid committed checkpoint in {self.directory}"
            + (" (newest candidates were quarantined)" if fell_back else ""))

    def _load_dir(self, dirpath: str, shardings=None, target=None) -> Dict:
        loaded = dist_ckpt.load_state_dict(dirpath, shardings=shardings,
                                           target=target, device=self.device)
        flat = _flatten(loaded)
        scalars_path = os.path.join(dirpath, _SCALARS_FILE)
        if os.path.isfile(scalars_path):
            with open(scalars_path) as f:
                flat.update(json.load(f))
        return _unflatten(flat)

    def restore_or_init(self, default: Any = None,
                        shardings: Optional[Dict] = None,
                        target: Optional[Dict] = None) -> RestoreResult:
        """One-call auto-resume: the newest valid committed state, or
        ``default`` when the directory holds nothing restorable."""
        try:
            state, step = self.restore(shardings=shardings, target=target)
        except CheckpointNotFoundError:
            return RestoreResult(default, None, False)
        return RestoreResult(state, step, True)

    # ------------------------------------------------------- preemption
    def save_on_signal(self, state_fn: Callable[[], Tuple[int, Dict]],
                       signals: Tuple = (_signal.SIGTERM, _signal.SIGINT),
                       exit_on_save: bool = True,
                       drain_timeout_s: float = 10.0) -> "_SignalScope":
        """Install preemption handlers: on SIGTERM/SIGINT, call
        ``state_fn() -> (step, state)``, commit it synchronously, and (by
        default) exit 0 — a clean preemption the next job resumes from via
        ``restore_or_init``. In-flight async saves are drained first
        (bounded by ``drain_timeout_s`` — preemption notices carry a grace
        period, and a writer wedged on the lock our interrupted frame holds
        must not hang the handler). Returns a scope usable as a context
        manager; ``scope.uninstall()`` (or scope exit) restores the old
        handlers. Main-thread only, like any Python signal handler; not
        inside a CUDA-graph capture (module docstring)."""

        def _handler(signum, frame):
            self.preempted = True
            try:
                # drain in-flight async saves first: one of them may be
                # committing the very step we'd save (racing its rename),
                # and anything already queued should land before we exit
                _drain_pending(drain_timeout_s)
                step, state = state_fn()
                # a wedged async save may publish our step AFTER the
                # drain timed out — losing that race means the checkpoint
                # is durable, which is success here
                self.save_if_absent(int(step), state)
            finally:
                scope.uninstall()
            if exit_on_save:
                sys.exit(0)

        scope = faults.install_signal_handler(_handler, signals=signals)
        return scope


_SignalScope = faults.SignalScope
