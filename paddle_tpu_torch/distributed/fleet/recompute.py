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

Policies, the JAX package's names (``_POLICIES`` and the
``jax.checkpoint_policies`` it resolves), through
``torch.utils.checkpoint.create_selective_checkpoint_contexts``:

- ``None``, ``"full"`` and ``"nothing_saveable"``: recompute everything;
- ``"dots"``/``"dots_saveable"``: save the output of every matrix
  product (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm`` and
  ``_scaled_mm``, what ``F.linear`` and ``matmul`` dispatch to) and
  recompute the rest;
- ``"dots_no_batch"``/``"dots_with_no_batch_dims"``: save only the
  products without batch dims (``mm``, ``addmm``), as
  ``dots_with_no_batch_dims_saveable`` does;
- ``"everything_saveable"``: save every output (no recompute).

Flash attention (K1-K3) reaches torch through an ``autograd.Function``,
no ``aten`` product, so it is recomputed under every policy, as no JAX
policy saves a ``pallas_call``'s output: K1 runs twice a block under each.
Any other ``jax.checkpoint_policies`` name, and a callable (a JAX policy
over primitives), raises ``ValueError`` naming what the port accepts.
``use_reentrant`` is accepted for the API and ignored (non-reentrant
always), as the JAX package accepts it.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ... import amp
from ... import generator as _generator

__all__ = ["recompute", "POLICIES"]

_aten = torch.ops.aten
_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default,
                     _aten._scaled_mm.default}
_EVERYTHING = object()  # every op's output saved

#: policy name -> the aten ops whose outputs are saved (None: recompute
#: everything)
POLICIES = {
    "full": None,
    "nothing_saveable": None,
    "dots": _DOTS,
    "dots_saveable": _DOTS,
    "dots_no_batch": _NO_BATCH,
    "dots_with_no_batch_dims": _NO_BATCH,
    "dots_with_no_batch_dims_saveable": _NO_BATCH,
    "everything_saveable": _EVERYTHING,
}


def _resolve_policy(policy):
    """The saved ops of ``policy`` (module docstring)."""
    if policy is None:
        return None
    if isinstance(policy, str) and policy in POLICIES:
        return POLICIES[policy]
    raise ValueError(
        f"recompute policy {policy!r} is not supported by the port; named "
        f"options: None or {sorted(POLICIES)} (a JAX checkpoint policy "
        "over primitives does not apply to torch ops)")


def _saving(saved):
    """A ``context_fn`` for ``checkpoint`` that saves the outputs of the
    ops in ``saved`` (every op's for ``_EVERYTHING``) and recomputes the
    rest."""
    def policy_fn(ctx, op, *args, **kwargs):
        keep = saved is _EVERYTHING or op in saved
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


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
    saved = _resolve_policy(policy)
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

    if saved is None:
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=_saving(saved))
