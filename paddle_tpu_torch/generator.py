"""Seeds of the port: counterpart of ``paddle_tpu/generator.py`` (``seed``).

One host-side ``torch.Generator`` is the global seed source, as the JAX
package's default generator is: :func:`seed` resets it, models draw their
init seed from it when given none, and dropout draws its seeds from it
(ints below 2^24, the range the flash kernels' dropout hash takes). A
device-side random draw gets its own ``torch.Generator`` on the tensor's
device, seeded from this one (:func:`device_generator`). The streams are
not the JAX package's: tests hand both packages the same inputs, and a
state from :func:`get_rng_state` restores only this package's stream.

The seed itself is kept (:func:`initial_seed`), as the JAX generator
keeps ``_seed``: host-side shuffling (``io``'s samplers, ``random_split``)
draws from ``np.random.default_rng((seed, ...))`` streams
(:func:`host_rng`), which equal the JAX package's index for index for one
``paddle.seed``. Nothing here calls ``torch.Generator.seed()``, which
reseeds a generator from a non-deterministic source.

Seeds as data. Dropout (``nn.functional.dropout``, the flash kernels)
takes its seed as a 0-d int32 tensor on its device, ``next_seed(device)``,
which the kernels read from device memory, as the Pallas kernels read
their ``seed_ref``. Outside a :class:`SeedTape` that is a new tensor
holding the next host draw. Inside one (``jit.StaticFunction`` opens it
for every call) it is a slot of the tape's seed buffer, whose address
stays fixed across calls:

- a tape in ``"fill"`` mode (an eager call) writes each draw into its
  slot on the stream as it is made;
- a tape in ``"record"`` mode (a CUDA-graph capture) hands out the slots
  and logs the host generator's draws and state moves (a recompute sets
  the generator back to redraw its forward's seeds). Before each replay
  :meth:`SeedTape.run` plays the log again on the host generator and
  stages the draws into the slots: the same draws, in the same order,
  that an eager call makes, so after N calls the host stream stands
  where N eager calls leave it.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["default_generator", "seed", "initial_seed", "set_initial_seed",
           "host_rng", "next_seed", "device_generator", "get_rng_state",
           "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state",
           "SeedTape", "SEED_SLOTS"]

SEED_BOUND = 1 << 24
# slots of a tape's seed buffer per device: one a dropout site per call
SEED_SLOTS = 4096

default_generator = torch.Generator().manual_seed(0)
# the value paddle.seed set, and the count of host_rng streams drawn since
_seed = 0
_host_counter = itertools.count()

_tape: Optional["SeedTape"] = None


def seed(value: int) -> torch.Generator:
    """Reseed the global generator (``paddle.seed``); returns it. The
    :func:`host_rng` streams start again from the first."""
    global _seed, _host_counter
    _seed = int(value)
    _host_counter = itertools.count()
    return default_generator.manual_seed(_seed)


def initial_seed() -> int:
    """The value the last :func:`seed` set (0 before any)."""
    return _seed


def set_initial_seed(value: int) -> None:
    """Put back a seed read by :func:`initial_seed` (a checkpoint's)
    without touching the generator's state, which
    :func:`set_rng_state` restores on its own."""
    global _seed
    _seed = int(value)


def host_rng() -> np.random.Generator:
    """A fresh seeded numpy stream for host-side shuffling and splits:
    ``default_rng((seed, n))`` for the n-th call since :func:`seed`, as
    the JAX package's ``host_rng``."""
    return np.random.default_rng((_seed, next(_host_counter)))


def _draw() -> int:
    return int(torch.randint(0, SEED_BOUND, (1,), generator=default_generator))


def next_seed(device=None):
    """The next seed drawn from the global generator, in [0, 2^24): an int,
    or with ``device`` a 0-d int32 tensor there holding it (a slot of the
    open :class:`SeedTape`, if any)."""
    value = _draw()
    if device is None:
        return value
    device = torch.device(device)
    if _tape is not None:
        return _tape.slot(device, value)
    return torch.full((), value, dtype=torch.int32, device=device)


def device_generator(device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device``, seeded by
    :func:`next_seed`."""
    return torch.Generator(device=device).manual_seed(next_seed())


def get_rng_state() -> torch.Tensor:
    """The global generator's state (``paddle.get_rng_state``)."""
    state = default_generator.get_state()
    if _tape is not None:
        _tape.saved(state)
    return state


def set_rng_state(state: torch.Tensor) -> None:
    """Restore a state from :func:`get_rng_state`: the draws after it
    repeat."""
    if _tape is not None:
        _tape.loaded(state)
    default_generator.set_state(state)


def get_cuda_rng_state() -> torch.Tensor:
    """``paddle.get_cuda_rng_state``: every draw on a card is seeded from
    the global generator (:func:`device_generator`, :func:`next_seed`),
    so the card's state is that generator's, as the JAX package's one
    device generator's is."""
    return get_rng_state()


def set_cuda_rng_state(state: torch.Tensor) -> None:
    """Restore a state from :func:`get_cuda_rng_state`."""
    set_rng_state(state)


class SeedTape:
    """The seed buffers of one step program (module docstring). Open it
    with ``with tape.open(mode):`` around one call of the step."""

    def __init__(self):
        self.buffers: Dict[torch.device, torch.Tensor] = {}
        self._mode: Optional[str] = None
        self._next: Dict[torch.device, int] = {}
        # the record: ("draw", device, slot) / ("save", mark) /
        # ("load", mark) / ("set", state), and the values drawn then
        self.log: List[tuple] = []
        self.recorded: Dict[tuple, int] = {}
        self._marks: Dict[int, int] = {}
        self._keep: List[torch.Tensor] = []

    def buffer(self, device: torch.device) -> torch.Tensor:
        buf = self.buffers.get(device)
        if buf is None:
            buf = torch.zeros(SEED_SLOTS, dtype=torch.int32, device=device)
            self.buffers[device] = buf
        return buf

    def open(self, mode: str):
        """A context in which :func:`next_seed` takes this tape's slots:
        ``"fill"`` writes each draw now, ``"record"`` logs it."""
        if mode not in ("fill", "record"):
            raise ValueError(f"seed tape mode {mode!r}")
        return _Opened(self, mode)

    def slot(self, device: torch.device, value: int) -> torch.Tensor:
        i = self._next.get(device, 0)
        if i >= SEED_SLOTS:
            raise RuntimeError(f"a step drew more than {SEED_SLOTS} dropout "
                               f"seeds on {device}")
        self._next[device] = i + 1
        s = self.buffer(device)[i]
        if self._mode == "fill":
            s.fill_(value)
        else:
            self.log.append(("draw", device, i))
            self.recorded[(device, i)] = value
        return s

    def saved(self, state: torch.Tensor) -> None:
        if self._mode == "record":
            self._marks[id(state)] = len(self._keep)
            self.log.append(("save", len(self._keep)))
            self._keep.append(state)

    def loaded(self, state: torch.Tensor) -> None:
        if self._mode == "record":
            mark = self._marks.get(id(state))
            self.log.append(("load", mark) if mark is not None
                            else ("set", state.clone()))

    def run(self) -> Dict[torch.device, List[int]]:
        """Play the record on the host generator: the values of each
        device's slots, in slot order, that an eager call would draw."""
        vals: Dict[torch.device, List[int]] = {}
        marks: List[torch.Tensor] = []
        for ev in self.log:
            if ev[0] == "draw":
                vals.setdefault(ev[1], []).append(_draw())
            elif ev[0] == "save":
                marks.append(default_generator.get_state())
            elif ev[0] == "load":
                default_generator.set_state(marks[ev[1]])
            else:
                default_generator.set_state(ev[1])
        return vals

    def recorded_values(self) -> Dict[torch.device, List[int]]:
        """The values drawn while the record was made, as :meth:`run`
        gives them."""
        vals: Dict[torch.device, List[int]] = {}
        for ev in self.log:
            if ev[0] == "draw":
                vals.setdefault(ev[1], []).append(self.recorded[ev[1:]])
        return vals


class _Opened:
    def __init__(self, tape: SeedTape, mode: str):
        self.tape, self.mode = tape, mode

    def __enter__(self):
        global _tape
        if _tape is not None:
            raise RuntimeError("a seed tape is already open (a step "
                               "program called inside another)")
        self.tape._mode = self.mode
        self.tape._next = {}
        if self.mode == "record":
            self.tape.log, self.tape.recorded = [], {}
            self.tape._marks, self.tape._keep = {}, []
        _tape = self.tape
        return self.tape

    def __exit__(self, *exc):
        global _tape
        _tape = None
        self.tape._mode = None
        self.tape._marks, self.tape._keep = {}, []
        return False
