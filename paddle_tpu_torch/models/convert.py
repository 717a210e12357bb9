"""Carry weights across from the JAX package's ``state_dict``.

A Paddle ``Layer`` model of the port (BERT) holds the JAX model's
names, layouts and buffers, and takes its ``state_dict`` as it is. For
the ``torch.nn`` models (GPT, Llama) the JAX package and the port name
every parameter alike
(``llama.layers.0.self_attn.q_proj.weight``,
``gpt.layers.0.attn.qkv_proj.weight``, ...). Its ``Linear`` stores
``[in, out]`` and ``torch.nn.Linear`` ``[out, in]``, so every Linear
weight is transposed on the way in; embeddings, biases and norms copy as
they are. Loading is strict: every key on both sides is used and every
shape must match.

bf16 arrays (``ml_dtypes.bfloat16``, what the JAX package's ``state_dict``
holds after ``amp.decorate(level="O2")``) cross as their 16-bit patterns:
numpy ``uint16`` -> ``torch.int16`` -> ``.view(torch.bfloat16)``, so the
values arrive bit for bit and never pass through f32. A value may also
be a torch tensor or a port ``Tensor`` (a restored checkpoint's), copied
on its device without a host round trip.

:func:`reference_state_dict` is the way back: a ``torch.nn`` model's
parameters under the reference's names and layouts (Linears transposed
to ``[in, out]``), what a checkpoint for ``serving.Router.reload`` holds.

A tensor-parallel model (``mp`` above 1) holds shards where the JAX
model holds whole weights: loading takes this rank's block of each
sharded parameter along its module's ``shard_dim`` (each of a fused
weight's ``shard_pieces`` split alike, so a rank's QKV block is its
heads' q, k and v), and :func:`reference_state_dict` gathers the blocks
back over the ``mp`` group (a collective call: every rank of the group
makes it) into whole weights.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..nn.layer_base import Layer

__all__ = ["load_reference_state_dict", "reference_state_dict",
           "split_shard", "gather_shard"]


def _shards(model: nn.Module) -> Dict[str, nn.Module]:
    """Parameter name -> its tensor-parallel module, for the parameters
    a rank holds a block of (a row-parallel bias is whole)."""
    out = {}
    for name, m in model.named_modules():
        dim = getattr(m, "shard_dim", None)
        if dim is None:
            continue
        for pname, _ in m.named_parameters(recurse=False):
            if pname == "bias" and dim == 1:
                continue
            out[f"{name}.{pname}" if name else pname] = m
    return out


def split_shard(full: torch.Tensor, dim: int, pieces: int, rank: int,
                n: int) -> torch.Tensor:
    """Rank ``rank``'s block (of ``n``) of ``full`` along ``dim``, each of
    its ``pieces`` split alike."""
    return torch.cat([p.chunk(n, dim)[rank]
                      for p in full.chunk(pieces, dim)], dim)


def gather_shard(local: torch.Tensor, dim: int, pieces: int,
                 group) -> torch.Tensor:
    """The whole tensor of which every rank of ``group`` holds
    ``local`` (:func:`split_shard`'s inverse)."""
    from ..distributed import collective

    parts = []
    collective.all_gather(parts, local.detach().contiguous(), group=group)
    blocks = [p.chunk(pieces, dim) for p in parts]
    return torch.cat([torch.cat([b[i] for b in blocks], dim)
                      for i in range(pieces)], dim)


@torch.no_grad()
def load_reference_state_dict(model: nn.Module,
                              ref: Dict[str, np.ndarray]) -> None:
    """Copy ``ref`` (the JAX model's ``state_dict()`` as numpy arrays, or
    torch tensors / Tensors in its layout) into ``model`` in place, in
    the model's dtype and on its device. Raises ``KeyError`` on a missing
    or unexpected key and ``ValueError`` on a shape mismatch, before any
    parameter is written. A Paddle ``Layer`` model (BERT) has the
    reference's names, layouts and buffers, so it loads through
    ``set_state_dict`` with no transposes."""
    if isinstance(model, Layer):
        missing, unexpected = model.set_state_dict(ref)
        if missing or unexpected:
            raise KeyError(f"state dict mismatch: missing {missing}, "
                           f"unexpected {unexpected}")
        return
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    params = dict(model.named_parameters())
    shards = _shards(model)
    missing = sorted(set(params) - set(ref))
    unexpected = sorted(set(ref) - set(params))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    srcs = {}
    for key, p in params.items():
        src = getattr(ref[key], "_value", ref[key])
        if isinstance(src, torch.Tensor):
            src = src.detach()
            shape = tuple(src.shape)
            src = src.t() if key in linear else src
        else:
            src = np.asarray(src)
            shape = tuple(src.shape)
            src = src.T if key in linear else src
        m = shards.get(key)
        if m is not None:
            src = src if isinstance(src, torch.Tensor) else _to_torch(src)
            dim = m.shard_dim if src.dim() > 1 else 0
            src = split_shard(src, dim, m.shard_pieces, m.group.rank,
                              m.group.nranks)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(
                f"{key}: reference shape {shape} does not fit "
                f"{tuple(p.shape)}"
                f"{' (transposed Linear)' if key in linear else ''}")
        srcs[key] = src
    for key, p in params.items():
        src = srcs[key]
        if not isinstance(src, torch.Tensor):
            src = _to_torch(src)
        p.copy_(src.to(p.device, p.dtype))


@torch.no_grad()
def reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s parameters under the reference's names and layouts:
    copies, each Linear weight transposed to ``[in, out]``, in the
    parameter's dtype and on its device, a tensor-parallel model's shards
    gathered whole (the inverse of :func:`load_reference_state_dict`)."""
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    shards = _shards(model)
    out = {}
    for k, p in model.named_parameters():
        v = p.detach()
        m = shards.get(k)
        if m is not None:
            v = gather_shard(v, m.shard_dim if v.dim() > 1 else 0,
                             m.shard_pieces, m.group)
        out[k] = v.t().contiguous() if k in linear else v.clone()
    return out


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor of its own dtype; bf16 by bit pattern."""
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch refuses it
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))
