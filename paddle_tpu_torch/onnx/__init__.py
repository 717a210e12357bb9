"""``paddle.onnx`` (``paddle_tpu/onnx/__init__.py``): ``export`` and
``export_decode`` on the exported graph.

The JAX package traces the forward to a jaxpr and converts it; the port
traces it with ``torch.export`` (non-strict, in eval mode under
``no_grad``, through ``Layer.__call__`` so forward pre-hooks such as
weight norm's run, a ``to_static`` forward unwrapped to its
``dygraph_function``, K1 off as ``paddle_tpu/onnx/__init__.py:157-162``
turns the Pallas kernel off) and converts the decomposed program
(``onnx/convert.py``) into a ModelProto at opset 18, written in raw wire
format (``onnx/wire.py``). A facade ``Layer``'s parameters are the
trace's inputs (``pure(params, *xs)``, as ``jit.save`` traces), a torch
module's are lifted by ``torch.export``; either way they are the file's
initializers. An ``InputSpec``'s ``None`` dims are traced at 1 and
written as ``dim_param``. Tensor control flow takes the exporting regime
of ``static/nn/control_flow.py``: ``static.nn.while_loop`` and
``StaticRNN`` become ONNX ``Loop``s; ``cond`` raises, as the JAX
converter has no rule for it. An unmapped operator raises
``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["export", "export_decode"]


def _examples(specs, device):
    """(example torch tensors, declared dims with None kept) of the
    input specs: a Tensor or array as it is, an ``InputSpec`` with its
    ``None`` (or negative) dims at 1."""
    from ..tensor import Tensor

    examples, dims = [], []
    for s in specs:
        if isinstance(s, Tensor):
            t = s._value
        elif isinstance(s, torch.Tensor):
            t = s
        elif isinstance(s, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(s))
        else:  # InputSpec
            d = [None if (v is None or int(v) < 0) else int(v)
                 for v in s.shape]
            dims.append(d)
            examples.append(torch.zeros([1 if v is None else v for v in d],
                                        dtype=s.dtype, device=device))
            continue
        examples.append(t.detach().to(device))
        dims.append(list(t.shape))
    return examples, dims


def export(layer, path: str, input_spec=None, opset_version: int = 18,
           **configs):
    """``paddle.onnx.export``: write ``path`` + ``.onnx`` (module
    docstring) and return the file's path."""
    from ..device import resolve_device, using_device
    from ..jit.dy2static import flag_device
    from ..jit.save_load import _Pure, _state
    from ..nn.functional import attention as _attn
    from ..nn.layer_base import Layer
    from .convert import program_to_model

    if input_spec is None:
        raise ValueError("paddle_tpu_torch.onnx.export requires input_spec")
    if opset_version < 18:
        # axes-as-input reduce/squeeze forms are legal only from opset 18
        raise NotImplementedError(
            f"opset_version={opset_version} is not supported: this exporter "
            "emits opset>=18 op forms (ReduceMax/Squeeze with axes inputs)")
    specs = list(input_spec) if isinstance(input_spec, (list, tuple)) \
        else [input_spec]
    names, values = _state(layer)
    device = values[0].device if values else resolve_device(None)
    examples, dims = _examples(specs, device)

    # Layer.__call__ runs the hooks; a to_static forward is traced as its
    # dygraph function (the capture is the card's, not a graph's)
    restore = None
    fwd = layer
    sf = getattr(layer, "forward", None)
    if getattr(sf, "dygraph_function", None) is not None:
        restore = sf
        layer.forward = sf.dygraph_function
    elif getattr(layer, "dygraph_function", None) is not None:
        fwd = layer.dygraph_function
    if isinstance(layer, torch.nn.Module) and not isinstance(layer, Layer):
        # a torch module (the port's models) is traced as it is, its
        # parameters lifted by torch.export: 27% cheaper to decompose than
        # a dict of 147 parameter inputs (GPT's decode step)
        trace, args, names = layer, tuple(examples), []
    else:
        # pure(params, *xs), as jit.save traces it; fwd is the layer
        # itself, so Layer.__call__ runs its hooks
        trace = _Pure(layer if isinstance(layer, Layer) else None, fwd,
                      names, lambda spec: None, wrap=True)
        args = ({n: v.detach() for n, v in zip(names, values)}, *examples)
    was_training = bool(getattr(layer, "training", False))
    if hasattr(layer, "eval"):
        layer.eval()
    prev_flash = _attn.pallas_flash_enabled
    _attn.pallas_flash_enabled = False
    try:
        with torch.no_grad(), using_device(device), flag_device(device):
            ep = torch.export.export(trace, args, strict=False)
            ep = ep.run_decompositions()
    finally:
        _attn.pallas_flash_enabled = prev_flash
        if restore is not None:
            layer.forward = restore
        if was_training and hasattr(layer, "train"):
            layer.train()
    input_names = getattr(layer, "input_names", None) or [
        getattr(s, "name", None) or f"input_{i}"
        for i, s in enumerate(specs)]
    model, _ = program_to_model(ep, input_names, dims, len(names), values,
                                opset=opset_version)
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.write(model)
    return out_path


class _DecodeStep(torch.nn.Module):
    """The greedy KV-cache decode step of a ``GenerationMixin`` model:
    ``(tokens, cur_len, past_k_0, past_v_0, ...) -> (next token, new
    caches)`` (``paddle_tpu/onnx/__init__.py:24``)."""

    def __init__(self, model, n_layers: int, names: Sequence[str]):
        super().__init__()
        self.model = model
        self.n_layers = n_layers
        self.input_names = list(names)

    def forward(self, tok, cur, *flat):
        caches = [(flat[2 * i], flat[2 * i + 1])
                  for i in range(self.n_layers)]
        hidden, ncs = self.model._decode_trunk()(tok, caches=caches,
                                                 cur_len=cur)
        logits = self.model.logits(hidden)
        nxt = torch.argmax(logits[:, -1, :].to(torch.float32),
                           dim=-1).to(torch.int32)
        return (nxt, *[t for c in ncs for t in c])


def export_decode(model, path: str, batch: int = 1, step_len: int = 1,
                  opset_version: int = 18):
    """Export a ``GenerationMixin`` model's greedy KV-cache decode step
    (the JAX package's I/O: ``tokens`` int64 ``[batch, step_len]``,
    ``cur_len`` int32, then ``past_k_i``/``past_v_i`` f32 ``[batch,
    total, heads, D]``; out the next token (int32) and the new caches).
    The host loops over tokens, each step one run of the graph."""
    n_layers, heads, hd = model._cache_spec()
    total = model.config.max_position_embeddings
    device = model.device
    names = ["tokens", "cur_len"]
    specs = [torch.zeros((batch, step_len), dtype=torch.int64,
                         device=device),
             torch.zeros((), dtype=torch.int32, device=device)]
    for i in range(n_layers):
        for kv in ("k", "v"):
            names.append(f"past_{kv}_{i}")
            specs.append(torch.zeros((batch, total, heads, hd),
                                     dtype=torch.float32, device=device))
    # in the model's mode, which export() puts back after its eval trace
    step = _DecodeStep(model, n_layers, names).train(model.training)
    return export(step, path, input_spec=specs, opset_version=opset_version)
