"""``paddle.autograd`` of the port (``paddle_tpu/autograd``): the tape
is torch autograd's (:mod:`.engine`), ``PyLayer`` sits on
``torch.autograd.Function`` (:mod:`.py_layer`), and
``saved_tensors_hooks`` is ``torch.autograd.graph.saved_tensors_hooks``:
``pack`` gets each torch tensor an op saves for its backward and
``unpack`` gives it back."""
import torch

from .engine import (apply_op, backward, enable_grad, grad, inplace_rebind,
                     is_grad_enabled, no_grad, set_grad_enabled)
from .py_layer import PyLayer, PyLayerContext

saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks
# a node of the tape: torch autograd's (``Tensor.grad_fn``)
GradNode = torch.autograd.graph.Node

__all__ = ["GradNode", "apply_op", "backward", "grad", "is_grad_enabled", "no_grad",
           "enable_grad", "set_grad_enabled", "inplace_rebind", "PyLayer",
           "PyLayerContext", "saved_tensors_hooks"]
