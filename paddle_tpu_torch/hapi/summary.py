"""``paddle.summary`` (``paddle_tpu/hapi/summary.py``): one row a leaf
layer (its type and order, its output's shape, its own parameter count)
from a forward on ones (zeros for an integer dtype) under ``no_grad`` in
eval mode, then the totals. Takes a facade ``nn.Layer`` (its forward
post-hooks) or a torch module (its forward hooks; every parameter with
``requires_grad`` counts as trainable).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["summary"]


def _numel(p) -> int:
    return int(np.prod(tuple(p.shape))) if len(p.shape) else 1


def summary(net, input_size=None, dtypes=None, input=None) -> dict:
    """Print the per-layer table; returns ``{'total_params',
    'trainable_params'}``."""
    from .. import to_tensor
    from ..autograd import no_grad

    facade = not isinstance(net, torch.nn.Module)
    if input is None:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        shapes = (input_size if isinstance(input_size, list)
                  else [input_size])
        dts = dtypes if isinstance(dtypes, (list, tuple)) else \
            [dtypes or "float32"] * len(shapes)
        inputs = []
        for shape, dt in zip(shapes, dts):
            shape = tuple(abs(int(s)) if s is not None else 1 for s in shape)
            fill = np.zeros if "int" in str(dt) else np.ones
            inputs.append(to_tensor(fill(shape, dtype=str(dt))))
        if not facade:
            dev = next(net.parameters()).device
            inputs = [t._value.to(dev) for t in inputs]
    else:
        inputs = input if isinstance(input, (list, tuple)) else [input]

    rows, hooks = [], []

    def hook(lyr, inp, out):
        out0 = out[0] if isinstance(out, (list, tuple)) else out
        own = (lyr.parameters(include_sublayers=False) if facade
               else lyr.parameters(recurse=False))
        rows.append((f"{type(lyr).__name__}-{len(rows)}",
                     list(getattr(out0, "shape", [])),
                     sum(_numel(p) for p in own)))

    leaves = (net.named_sublayers() if facade else
              ((n, m) for n, m in net.named_modules() if n))
    for _, layer in leaves:
        if not list(layer.children()):
            hooks.append(layer.register_forward_post_hook(hook) if facade
                         else layer.register_forward_hook(hook))
    was_training = net.training
    net.eval()
    try:
        with no_grad():
            net(*inputs)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    params = list(net.parameters())
    total = sum(_numel(p) for p in params)
    trainable = sum(_numel(p) for p in params
                    if (not p.stop_gradient if facade else p.requires_grad))
    name_w = max([len(r[0]) for r in rows] + [12]) + 2
    shape_w = max([len(str(r[1])) for r in rows] + [14]) + 2
    print("-" * (name_w + shape_w + 12))
    print("Layer (type)".ljust(name_w) + "Output Shape".ljust(shape_w)
          + "Param #")
    print("=" * (name_w + shape_w + 12))
    for name, shape, n in rows:
        print(name.ljust(name_w) + str(shape).ljust(shape_w) + f"{n:,}")
    print("=" * (name_w + shape_w + 12))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * (name_w + shape_w + 12))
    return {"total_params": total, "trainable_params": trainable}
