"""``paddle.flops`` (``paddle_tpu/utils/flops.py``): the flops of one
forward pass.

The JAX package reads XLA's cost analysis of the traced forward, which
counts every operation (elementwise ones too). The port counts what
``StaticFunction.cost_analysis`` counts: the products and convolutions
by ``torch.utils.flop_counter``'s formulas (``_FlopCount``: 2 m n k a
product, the convolution's multiply-adds times 2), plus the flash
kernels' flops (``ops.flash_attention.flop_log``). Elementwise work,
norms and softmaxes are left out, by design.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["flops"]


def _device(net) -> torch.device:
    params = list(net.parameters())
    if not params:
        from ..device import default_device

        return default_device()
    p = params[0]
    return getattr(p, "_value", p).device


def flops(net, input_size: Sequence[int], custom_ops=None,
          print_detail: bool = False) -> int:
    """The flops of ``net`` (a facade ``nn.Layer`` or a torch module) on
    one f32 input of ``input_size`` (batch dim included), zeros on the
    device of its parameters, under ``no_grad``."""
    from ..jit.static_function import _FlopCount
    from ..ops import flash_attention as fa
    from ..tensor import Tensor

    x = torch.zeros(tuple(int(s) for s in input_size), dtype=torch.float32,
                    device=_device(net))
    facade = not isinstance(net, torch.nn.Module)
    fa.flop_log, log = [], fa.flop_log
    try:
        with torch.no_grad(), _FlopCount() as count:
            net(Tensor._wrap(x) if facade else x)
        kernels = sum(f for _, f in fa.flop_log)
    finally:
        fa.flop_log = log
    total = count.total + kernels
    if print_detail:
        print(f"FLOPs: {total:,} (products and convolutions "
              f"{count.total:,}, flash kernels {kernels:,})")
    return total
