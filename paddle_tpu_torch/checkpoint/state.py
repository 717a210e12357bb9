"""Train-state capture and restore: params, optimizer, RNG, data position
(``paddle_tpu/checkpoint/state.py``).

Sample-exact resume needs more than parameters: the optimizer moments,
the RNG state, and where the dataloader was (epoch and batch offset).
:func:`capture_train_state` gathers them into one nested dict a
:class:`~.manager.CheckpointManager` commits at once;
:func:`restore_train_state` puts them back. Any object with
``state_dict``/``set_state_dict`` works as ``model``.

The RNG state is this package's own: the host generator's
``torch.Generator`` state (``generator.get_rng_state``, a ``uint8``
tensor) and the seed ``paddle.seed`` set. Dropout (``F.dropout``, the
flash kernels) draws its seeds from that generator, so a dropout model
resumes sample-exact only with it restored. The JAX package saves a
threefry key there instead (``key_data``), which cannot be restored
into this generator: :func:`set_rng_state_dict` raises ``ValueError``
for it, and a caller carrying a JAX checkpoint restores the model,
optimizer and data entries without the ``rng`` one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import generator
from ..tensor import Tensor

__all__ = [
    "capture_train_state", "restore_train_state", "rng_state_dict",
    "set_rng_state_dict",
]


def rng_state_dict() -> Dict[str, Any]:
    """The global generator's state and the seed (host-side shuffling
    derives from ``(seed, epoch)``, so the seed travels too)."""
    return {"torch_state": Tensor(generator.get_rng_state().clone()),
            "seed": int(generator.initial_seed())}


def set_rng_state_dict(state: Dict[str, Any]) -> None:
    """Restore a :func:`rng_state_dict` (values may be Tensors fresh off a
    checkpoint). Raises ``ValueError`` for the JAX package's threefry
    ``key_data``. Call it outside a ``SeedTape`` (a step program's
    call)."""
    if generator._tape is not None:
        raise RuntimeError("set_rng_state_dict inside a step program's "
                           "seed tape: restore between calls")
    if "torch_state" not in state:
        raise ValueError(
            "this rng state was written by the JAX package (a threefry "
            f"key, keys {sorted(state)}); it cannot be restored into this "
            "package's generator: restore the model, optimizer and data "
            "entries without the 'rng' one")
    data = state["torch_state"]
    data = getattr(data, "_value", data)
    if "seed" in state:
        generator.set_initial_seed(int(state["seed"]))
    generator.set_rng_state(torch.as_tensor(data).to("cpu", torch.uint8))


def capture_train_state(model=None, optimizer=None, dataloader=None,
                        step: Optional[int] = None,
                        extra: Optional[Dict] = None,
                        sentinel=None) -> Dict[str, Any]:
    """One nested dict holding everything resume needs; omitted pieces are
    absent, ``step`` rides as an exact int. ``sentinel`` adds its journal
    and escalation state (pure scalars: they land in ``scalars.json``).
    ``model.state_dict()`` is the live cells: a caller that keeps this
    dict across a step snapshots it first (a checkpoint save copies)."""
    state: Dict[str, Any] = {"rng": rng_state_dict()}
    if model is not None:
        state["model"] = model.state_dict()
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if dataloader is not None:
        state["dataloader"] = dataloader.state_dict()
    if sentinel is not None:
        state["sentinel"] = sentinel.state_dict()
    if step is not None:
        state["step"] = int(step)
    if extra:
        state["extra"] = dict(extra)
    return state


def restore_train_state(state: Dict[str, Any], model=None, optimizer=None,
                        dataloader=None, sentinel=None) -> Optional[int]:
    """Put a :func:`capture_train_state` dict back into live objects and
    return its ``step`` (None if not captured). ``sentinel`` is restored
    only when passed: a rollback keeps its live incident state."""
    if "rng" in state:
        set_rng_state_dict(state["rng"])
    if model is not None and "model" in state:
        model.set_state_dict(state["model"])
    if optimizer is not None and "optimizer" in state:
        optimizer.set_state_dict(state["optimizer"])
    if dataloader is not None and "dataloader" in state:
        dataloader.set_state_dict(state["dataloader"])
    if sentinel is not None and "sentinel" in state:
        sentinel.set_state_dict(state["sentinel"])
    step = state.get("step")
    return None if step is None else int(step)
