"""Seeds of the port: counterpart of ``paddle_tpu/generator.py`` (``seed``).

One host-side ``torch.Generator`` is the global seed source, as the JAX
package's default generator is: :func:`seed` resets it, models draw their
init seed from it when given none, and dropout draws its seeds from it
(ints below 2^24, the range the flash kernels' dropout hash takes). A
device-side random draw gets its own ``torch.Generator`` on the tensor's
device, seeded from this one (:func:`device_generator`). The streams are
not the JAX package's: tests hand both packages the same inputs, and a
state from :func:`get_rng_state` restores only this package's stream.
"""
from __future__ import annotations

import torch

__all__ = ["default_generator", "seed", "next_seed", "device_generator",
           "get_rng_state", "set_rng_state"]

SEED_BOUND = 1 << 24

default_generator = torch.Generator().manual_seed(0)


def seed(value: int) -> torch.Generator:
    """Reseed the global generator (``paddle.seed``); returns it."""
    return default_generator.manual_seed(int(value))


def next_seed() -> int:
    """The next seed drawn from the global generator, in [0, 2^24)."""
    return int(torch.randint(0, SEED_BOUND, (1,), generator=default_generator))


def device_generator(device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device``, seeded by
    :func:`next_seed`."""
    return torch.Generator(device=device).manual_seed(next_seed())


def get_rng_state() -> torch.Tensor:
    """The global generator's state (``paddle.get_rng_state``)."""
    return default_generator.get_state()


def set_rng_state(state: torch.Tensor) -> None:
    """Restore a state from :func:`get_rng_state`: the draws after it
    repeat."""
    default_generator.set_state(state)
