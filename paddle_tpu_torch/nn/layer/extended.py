"""The layer tail (``paddle_tpu/nn/layer/extended.py``): ``Softmax2D``,
``HSigmoidLoss``, ``MultiMarginLoss``, ``RNNTLoss``, and the seq2seq
decoding pair ``BeamSearchDecoder``/``dynamic_decode``.

Decoding is a host-driven loop, as in the reference (it stops when every
beam has finished, a host read a step); each step's math is torch ops
on the device of the decoder's state. A decoder state is any nest of
lists, tuples and dicts over tensors (facade, torch or numpy).
"""
from __future__ import annotations

import torch

from ...amp import cast_inputs
from ...device import default_device
from ...tensor import Tensor, facade_io, unwrap
from ..functional import extended as FX
from ..functional.common import as_torch
from ..layer_base import Layer

__all__ = ["Softmax2D", "HSigmoidLoss", "MultiMarginLoss", "RNNTLoss",
           "BeamSearchDecoder", "dynamic_decode"]


class Softmax2D(Layer):
    """Softmax over the channel dim of CHW or NCHW inputs."""

    @facade_io
    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError("Softmax2D expects CHW or NCHW input")
        (v,) = cast_inputs("softmax2d", as_torch(x))
        return torch.softmax(v, dim=-3)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree (or the
    given paths): weight ``[num_classes - 1, feature_size]``, bias
    ``[num_classes - 1, 1]`` unless ``bias_attr=False``."""

    def __init__(self, feature_size: int, num_classes: int,
                 weight_attr=None, bias_attr=None, is_custom: bool = False,
                 is_sparse: bool = False, name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr,
            default_initializer=None)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [num_classes - 1, 1], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, input, label, path_table=None, path_code=None):
        return FX.hsigmoid_loss(input, label, self.num_classes, self.weight,
                                bias=self.bias, path_table=path_table,
                                path_code=path_code)


class MultiMarginLoss(Layer):
    def __init__(self, p: int = 1, margin: float = 1.0, weight=None,
                 reduction: str = "mean", name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return FX.multi_margin_loss(input, label, p=self.p,
                                    margin=self.margin, weight=self.weight,
                                    reduction=self.reduction)


class RNNTLoss(Layer):
    def __init__(self, blank: int = 0, fastemit_lambda: float = 0.0,
                 reduction: str = "mean", name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return FX.rnnt_loss(input, label, input_lengths, label_lengths,
                            blank=self.blank,
                            fastemit_lambda=self.fastemit_lambda,
                            reduction=self.reduction)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


class BeamSearchDecoder:
    """Beam search over a step cell (``nn/decode.py:58`` of Paddle).

    ``cell(inputs [B*W] or their embeddings, states) -> (logits or
    hidden, new_states)``; ``output_fn`` maps the cell's output to vocab
    logits when the cell does not; ``embedding_fn`` embeds the tokens.
    """

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _tile(self, state, W):
        return _tree_map(lambda v: torch.as_tensor(unwrap(v))
                         .repeat_interleave(W, dim=0), state)

    def initialize(self, initial_states, batch_size: int):
        """``(tokens, states, log_probs, finished)`` at step 0: the states
        repeated per beam, every beam on ``start_token``, only beam 0 of
        each row live."""
        W = self.beam_size
        states = self._tile(initial_states, W)
        leaves = _leaves(states)
        dev = leaves[0].device if leaves else default_device()
        tokens = torch.full((batch_size * W,), self.start_token,
                            dtype=torch.int64, device=dev)
        probs = torch.tensor([0.0] + [-1e9] * (W - 1), dtype=torch.float32,
                             device=dev).repeat(batch_size)
        finished = torch.zeros(batch_size * W, dtype=torch.bool, device=dev)
        return tokens, states, probs, finished

    def step(self, tokens, states, log_probs, finished, batch_size: int):
        """One beam step: ``(tokens, states, log_probs, finished,
        source beam of each winner)``; a finished beam extends only with
        ``end_token``, at no cost."""
        W = self.beam_size
        inputs = (Tensor._wrap(tokens) if self.embedding_fn is None
                  else self.embedding_fn(Tensor._wrap(tokens)))
        out, new_states = self.cell(inputs, states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        logp = torch.log_softmax(
            as_torch(logits).to(torch.float32).to(tokens.device), dim=-1)
        V = logp.shape[-1]
        fin_mask = torch.full((V,), -1e9, device=logp.device)
        fin_mask[self.end_token] = 0.0
        logp = torch.where(finished[:, None], fin_mask[None, :], logp)
        total = (log_probs[:, None] + logp).reshape(batch_size, W * V)
        # lax.top_k's order: descending, the lower index first on ties
        top, idx = torch.sort(total, dim=-1, descending=True, stable=True)
        top, idx = top[:, :W], idx[:, :W]
        flat_src = (torch.arange(batch_size, device=idx.device)[:, None] * W
                    + idx // V).reshape(-1)
        new_states = _tree_map(lambda v: torch.as_tensor(unwrap(v))[flat_src],
                               new_states)
        tokens = (idx % V).reshape(-1)
        finished = finished[flat_src] | (tokens == self.end_token)
        return tokens, new_states, top.reshape(-1), finished, flat_src


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 32, batch_size: int = 1,
                   **kwargs):
    """Run ``decoder`` until every beam has finished or ``max_step_num``
    steps (``nn/decode.py:1007`` of Paddle). Returns ``(ids [B, W, T],
    log_probs [B, W])``, the ids backtracked through the parents."""
    tokens, states, probs, finished = decoder.initialize(inits, batch_size)
    W = decoder.beam_size
    step_tokens, step_parents = [], []
    for _ in range(max_step_num):
        tokens, states, probs, finished, src = decoder.step(
            tokens, states, probs, finished, batch_size)
        step_tokens.append(tokens.reshape(batch_size, W))
        step_parents.append(src.reshape(batch_size, W)
                            - torch.arange(batch_size,
                                           device=src.device)[:, None] * W)
        if bool(finished.all()):
            break
    full = FX.gather_tree(torch.stack(step_tokens),
                          torch.stack(step_parents))
    return (Tensor._wrap(full.movedim(0, -1)),
            Tensor._wrap(probs.reshape(batch_size, W)))
