"""Activation recompute (``paddle_tpu/distributed/fleet/recompute.py``).

``recompute(function, *args)`` runs ``function`` without keeping its
intermediate activations; the backward runs it again to rebuild them.
It is ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` with
three things of the JAX package's kept:

- The amp state: the recomputation runs in the backward, outside the
  forward's ``auto_cast`` block, so it runs under the state captured at
  the call (``amp.current_state``) and casts as the forward did.
- The amp cast of the op itself: the JAX package runs the checkpointed
  function as one tape op named ``recompute``, so under ``auto_cast`` its
  arguments and, for an ``nn.Module``, its parameters are cast by that
  name (under O2 to the amp dtype: an f32 norm weight enters the block
  rounded to bf16, and its grad comes back through that cast).
- The random state: with ``preserve_rng_state`` (the default) the
  recomputation draws the same seeds from the port's global generator
  (``generator.default_generator``, which dropout draws from) as the
  forward did: it sets the generator back to its state at the call
  through ``generator.get_rng_state``/``set_rng_state``, which a
  captured step's seed tape logs, so inside a CUDA graph the
  regenerated region reads seed slots that each replay fills with the
  forward's draws. Every dropout of the port is keyed by such a seed
  and draws nothing from torch's RNGs, so ``checkpoint`` is not asked
  to stash them (``preserve_rng_state=False``): its stash reads the
  CUDA generator on the host, which a capture refuses.

Policies: ``None`` and ``"full"`` (recompute everything). The JAX
package's named policies (``dots``, ``dots_no_batch`` and their aliases,
which save matmul outputs) raise ``NotImplementedError``: not ported yet.
``use_reentrant`` is accepted for the API and ignored (non-reentrant
always), as the JAX package accepts it.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ... import amp
from ... import generator as _generator

__all__ = ["recompute"]

# the JAX package's named policies (recompute.py _POLICIES): not ported
_NAMED_POLICIES = ("dots", "dots_saveable", "dots_no_batch",
                   "dots_with_no_batch_dims")


def _check_policy(policy) -> None:
    if policy is None or policy == "full":
        return
    if policy in _NAMED_POLICIES or callable(policy):
        raise NotImplementedError(
            f"recompute policy {policy!r} is not ported yet; use None or "
            "'full' (recompute everything)")
    raise ValueError(f"unknown recompute policy {policy!r}; named options: "
                     f"{sorted(('full',) + _NAMED_POLICIES)}")


@contextlib.contextmanager
def _generator_at(state):
    """Run the block with the global generator at ``state``, then put it
    back where it was."""
    now = _generator.get_rng_state()
    _generator.set_rng_state(state)
    try:
        yield
    finally:
        _generator.set_rng_state(now)


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, policy=None, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward (module docstring). ``function`` is an ``nn.Module`` or any
    callable of tensors; only a module's parameters take the amp cast."""
    del use_reentrant
    _check_policy(policy)
    state = amp.current_state()
    rng = _generator.get_rng_state() if preserve_rng_state else None
    calls = [0]

    def run(*xs):
        calls[0] += 1
        replay = (_generator_at(rng) if rng is not None and calls[0] > 1
                  else contextlib.nullcontext())
        with amp.restored_state(state), replay:
            xs = amp.cast_inputs("recompute", *xs)
            if isinstance(function, nn.Module) and state is not None:
                named = list(function.named_parameters())
                cast = amp.cast_inputs("recompute", *(p for _, p in named))
                swapped = {n: c for (n, p), c in zip(named, cast)
                           if c is not p}
                if swapped:
                    return torch.func.functional_call(function, swapped, xs,
                                                      kwargs)
            return function(*xs, **kwargs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)
