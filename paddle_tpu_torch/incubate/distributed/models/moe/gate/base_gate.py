"""reference: incubate/distributed/models/moe/gate/base_gate.py."""
from __future__ import annotations

from ......nn.layer_base import Layer


class BaseGate(Layer):
    """The gates' base. ``_ep`` is the expert-parallel group of the
    ``MoELayer`` the gate serves (set by the layer; None otherwise): its
    ranks' tokens together are the batch the JAX package's gate sees
    whole, so the gates reduce their statistics over it."""

    def __init__(self, num_expert: int, world_size: int):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None
        self._ep = None

    def forward(self, x):
        raise NotImplementedError("Base gate cannot be directly used for fwd")

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear: bool = True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    @property
    def has_loss(self) -> bool:
        return self.loss is not None

    def _ep_size(self) -> int:
        return 1 if self._ep is None else self._ep.nranks
