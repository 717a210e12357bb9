"""StaticRNN: the step built once, run over the time axis
(``paddle_tpu/static/nn/rnn.py``).

The reference records the step into a sub-block that a ``recurrent`` op
walks T times. The JAX package runs the ``with rnn.step():`` block once on
step-0 slices, recording it on its tape, and ``rnn()`` replays that
subgraph (``_replay_function``) under ``lax.scan``. The port records the
block with a program record of its own (``static/record.py``): the step
inputs and memories are its placeholders, and ``rnn()`` replays the
record once a time step, feeding the step's slices and the carried
memories, as one op (one node of an open program; torch autograd
differentiates through the steps). Under a ``torch.export`` trace
(``jit.save``, ``onnx.export``) the steps are one ``torch.while_loop``
carrying the step index, the memories and the stacked outputs, as the
JAX package's ``lax.scan`` (``paddle_tpu/static/nn/rnn.py:143``).
Sequence inputs are time-major, ``[T, B, ...]``.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import List, Optional

import torch

from ... import tensor as _tensor
from ...autograd.engine import apply_op
from ...tensor import Tensor
from .. import record as _record
from .control_flow import exporting, while_loop

__all__ = ["StaticRNN"]


class StaticRNN:
    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name: Optional[str] = None):
        self.name = name or "static_rnn"
        self.status = self.BEFORE_RNN
        self._seq: List[tuple] = []        # (full sequence, step placeholder)
        self._mems: List[list] = []        # [placeholder, init, new]
        self._outputs: List[Tensor] = []
        self._record = _record.Recorder(self)

    @contextmanager
    def step(self):
        if self.status != self.BEFORE_RNN:
            raise RuntimeError("StaticRNN.step() may only be entered once")
        self.status = self.IN_RNN
        outer = _tensor.program_recorder
        _tensor.program_recorder = self._record
        try:
            yield
        finally:
            _tensor.program_recorder = outer
            self.status = self.AFTER_RNN

    def _require_in_rnn(self, what):
        if self.status != self.IN_RNN:
            raise RuntimeError(f"StaticRNN.{what} must be called inside "
                               "`with rnn.step():`")

    def _placeholder(self, value: torch.Tensor) -> Tensor:
        ph = Tensor(value, stop_gradient=False)
        self._record.placeholder(f"in{len(self._seq) + len(self._mems)}",
                                 ph)
        return ph

    def step_input(self, x: Tensor) -> Tensor:
        """Register a time-major ``[T, B, ...]`` sequence; returns the
        step's ``[B, ...]`` slice the body computes on."""
        self._require_in_rnn("step_input")
        if self._seq and x.shape[0] != self._seq[0][0].shape[0]:
            raise ValueError("all StaticRNN step inputs must share sequence "
                             f"length; got {x.shape[0]} vs "
                             f"{self._seq[0][0].shape[0]}")
        ph = self._placeholder(x._value[0])
        self._seq.append((x, ph))
        return ph

    def memory(self, init: Optional[Tensor] = None, shape=None,
               batch_ref: Optional[Tensor] = None, init_value: float = 0.0,
               init_batch_dim_idx: int = 0, ref_batch_dim_idx: int = 1):
        """A carried state: ``init``, or ``init_value`` in ``shape`` with a
        -1 taken from ``batch_ref``'s batch dim."""
        self._require_in_rnn("memory")
        if init is not None:
            init_t = init if isinstance(init, Tensor) else Tensor(init)
        else:
            if shape is None or batch_ref is None:
                raise ValueError("StaticRNN.memory needs `init` or both "
                                 "`shape` and `batch_ref`")
            concrete = [batch_ref.shape[0] if int(d) < 0 else int(d)
                        for d in shape]
            ref = batch_ref._value
            init_t = Tensor(torch.full(concrete, init_value, dtype=ref.dtype,
                                       device=ref.device))
        ph = self._placeholder(init_t._value)
        self._mems.append([ph, init_t, None])
        return ph

    def update_memory(self, mem: Tensor, var: Tensor):
        self._require_in_rnn("update_memory")
        for rec in self._mems:
            if rec[0] is mem:
                rec[2] = var
                return
        raise ValueError("update_memory: unknown memory (pass the tensor "
                         "returned by StaticRNN.memory)")

    def step_output(self, o: Tensor):
        self._require_in_rnn("step_output")
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        if self.status != self.AFTER_RNN:
            raise RuntimeError("finish the `with rnn.step():` block before "
                               "calling the StaticRNN")
        if not self._outputs:
            raise ValueError("StaticRNN has no step_output")
        rec = self._record
        new_mems = [m[2] if m[2] is not None else m[0] for m in self._mems]
        srcs = [rec.source(t) for t in list(self._outputs) + new_mems]
        plan = _record.replay_plan(srcs)
        names = [rec.source(ph)[1] for _, ph in self._seq] + \
            [rec.source(m[0])[1] for m in self._mems]
        n_seq, n_out = len(self._seq), len(self._outputs)
        # the step's parameters join the op's inputs, so an open program
        # and minimize() see them
        params = list({id(s[1]): s[1] for node in plan for s in node.inputs
                       if s[0] == "cell"}.values())

        outs0 = [o._value for o in self._outputs]

        def run(*vals):
            if exporting(*vals):
                return exported(*vals)
            seqs = vals[:n_seq]
            carry = list(vals[n_seq:n_seq + len(self._mems)])
            steps: List[List[torch.Tensor]] = [[] for _ in range(n_out)]
            outer = _tensor.program_recorder
            with outer.pause() if outer is not None else nullcontext():
                for t in range(seqs[0].shape[0]):
                    feeds = dict(zip(names, [s[t] for s in seqs] + carry))
                    got = _record.run_plan(plan, srcs, feeds)
                    for i in range(n_out):
                        steps[i].append(got[i])
                    carry = got[n_out:]
            return tuple(torch.stack(s) for s in steps)

        def exported(*vals):
            # one torch.while_loop: the step index, the memories and the
            # stacked outputs are carried (the JAX package's lax.scan)
            seqs = vals[:n_seq]
            mems = list(vals[n_seq:n_seq + len(self._mems)])
            T = seqs[0].shape[0]
            bufs = [torch.zeros((T, *o.shape), dtype=o.dtype,
                                device=seqs[0].device) for o in outs0]
            t0 = torch.zeros((), dtype=torch.int64, device=seqs[0].device)

            def body(t, *carry):
                idx = t.reshape(1)
                steps = [s.index_select(0, idx)[0] for s in seqs]
                feeds = dict(zip(names, steps + list(carry[:len(mems)])))
                got = _record.run_plan(plan, srcs, feeds)
                outs = [b.index_put((idx,), g.unsqueeze(0))
                        for b, g in zip(carry[len(mems):], got[:n_out])]
                return [t + 1, *got[n_out:], *outs]

            res = while_loop(lambda t, *carry: t < T, body,
                             [t0, *mems, *bufs])
            return tuple(res[1 + len(mems):])

        ins = [x for x, _ in self._seq] + [m[1] for m in self._mems] + params
        res = apply_op(run, ins, name=self.name)
        res = res if isinstance(res, tuple) else (res,)
        return res[0] if len(res) == 1 else list(res)
