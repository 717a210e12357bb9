"""Shared signal-handler scope — ONE install/uninstall discipline for
every clean-exit path in the package.

Training (``CheckpointManager.save_on_signal``: SIGTERM → checkpoint →
exit 0) and serving (``Router.install_signal_handlers``: SIGTERM →
drain → seal-WAL → exit 0) react to the same preemption notice; before
this module each grew its own handler bookkeeping. The factored core is
deliberately tiny: :func:`install_signal_handler` snapshots the previous
handlers and returns a :class:`SignalScope` whose ``uninstall()`` is
IDEMPOTENT and swallows the only two errors restoration can
legitimately hit (not the main thread / interpreter tearing down) —
the part that is easy to get subtly wrong twice.

Scopes nest LIFO like the handlers they shadow: installing a second
scope snapshots the first's handler, and uninstalling in reverse order
restores the chain exactly (the double-install regression test in
the JAX package's WAL tests pin this). Stdlib-only, like the rest of
``paddle_tpu_torch.faults``.
"""
from __future__ import annotations

import signal as _signal
from typing import Callable, Dict, Tuple

__all__ = ["SignalScope", "install_signal_handler"]


class SignalScope:
    """Uninstaller for a batch of installed signal handlers.

    ``uninstall()`` restores the handlers that were live at install
    time, exactly once — a second call is a no-op (the snapshot is
    consumed), and restoration failures that only mean "this thread/
    interpreter can no longer touch signals" (ValueError, OSError) are
    swallowed: teardown must never raise out of a ``finally``. Also a
    context manager (``__exit__`` uninstalls)."""

    def __init__(self, prev: Dict):
        self._prev = prev

    def uninstall(self) -> None:
        prev, self._prev = self._prev, {}
        for sig, handler in prev.items():
            try:
                _signal.signal(sig, handler)
            except (ValueError, OSError):  # not main thread / torn down
                pass

    def __enter__(self) -> "SignalScope":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()


def install_signal_handler(handler: Callable,
                           signals: Tuple = (_signal.SIGTERM,)
                           ) -> SignalScope:
    """Install ``handler(signum, frame)`` for each signal in ``signals``
    and return the :class:`SignalScope` that restores the previous
    handlers. Main-thread only, like any Python signal handler. The
    handler owns its exit semantics (checkpoint-then-``sys.exit(0)``,
    drain-then-seal, ...); this function owns only the install/restore
    bookkeeping, so every caller gets the same idempotent teardown."""
    scope = SignalScope({})
    for sig in signals:
        scope._prev[sig] = _signal.signal(sig, handler)
    return scope
