"""Recurrent layers (``paddle_tpu/nn/layer/rnn.py``): the cells
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the wrappers ``RNN`` and
``BiRNN``, and ``SimpleRNN``, ``LSTM`` and ``GRU`` over ``_RNNBase``.

Gate order and weight names are the reference's: an LSTM's gates split
as ``i, f, g, o``, a GRU's as ``r, z, c`` with the reset gate on the
hidden product (``c = tanh(x_c + r * h_c)``, ``h' = (h - c) * z + c``);
``weight_ih_l{k}[_reverse]`` and friends per layer and direction, each
drawn from ``Uniform(-1/sqrt(hidden), 1/sqrt(hidden))``.

The reference's ``lax.scan`` is a Python loop over torch ops here: its
length is the input's, fixed for a signature, so a captured step holds
the whole loop. Each layer and direction projects the whole sequence's
input in one product first and adds the hidden product step by step (no
cuDNN RNN). The amp names are the reference's (``lstm_cell``,
``rnn_lstm``, ...), on neither list: bf16 under O2. The initial states
are f32 zeros. Inter-layer dropout acts only in training with more than
one layer, drawing its keep bits as ``functional.dropout`` does (from
the port's generator, so not the JAX bits).

``sequence_length`` is taken and ignored by ``RNN``, ``BiRNN`` and
``_RNNBase``, as in the reference: padded steps run like the others
(ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import torch

from ...autograd.engine import apply_op
from ...ops import concat, stack
from ...ops._apply import ensure_tensor
from ...tensor import Tensor
from ..functional.common import _keep
from ..layer_base import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value: float = 0.0, batch_dim_idx: int = 0):
        """f32 states of ``init_value``, ``[batch] + shape`` each, on
        ``batch_ref``'s device."""
        batch = batch_ref.shape[batch_dim_idx]
        dev = ensure_tensor(batch_ref)._value.device
        st_shape = shape or self.state_shape

        def full(s):
            return Tensor._wrap(torch.full((batch,) + tuple(s), init_value,
                                           dtype=torch.float32, device=dev))

        if (isinstance(st_shape, (list, tuple)) and st_shape
                and isinstance(st_shape[0], (list, tuple))):
            return tuple(full(s) for s in st_shape)
        return full(st_shape)


def _std_uniform(hidden_size):
    from .. import initializer as I

    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


def _act(activation):
    return torch.tanh if activation == "tanh" else torch.relu


def _lstm_gates(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_gates(gi, gh, h):
    ir, iz, ic = gi.chunk(3, dim=-1)
    hr, hz, hc = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    c = torch.tanh(ic + r * hc)
    return (h - c) * z + c


def _make_weights(layer, gates, input_size, hidden_size, attrs, init):
    wih_attr, whh_attr, bih_attr, bhh_attr = attrs
    layer.weight_ih = layer.create_parameter(
        [gates * hidden_size, input_size], attr=wih_attr,
        default_initializer=init)
    layer.weight_hh = layer.create_parameter(
        [gates * hidden_size, hidden_size], attr=whh_attr,
        default_initializer=init)
    layer.bias_ih = layer.create_parameter(
        [gates * hidden_size], attr=bih_attr, is_bias=True,
        default_initializer=init)
    layer.bias_hh = layer.create_parameter(
        [gates * hidden_size], attr=bhh_attr, is_bias=True,
        default_initializer=init)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size: int, hidden_size: int,
                 activation: str = "tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        _make_weights(self, 1, input_size, hidden_size,
                      (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                       bias_hh_attr), _std_uniform(hidden_size))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = _act(self.activation)

        def fn(x, h, wih, whh, bih, bhh):
            return act(x @ wih.T + bih + h @ whh.T + bhh)

        h = apply_op(fn, [ensure_tensor(inputs), ensure_tensor(states),
                          self.weight_ih, self.weight_hh, self.bias_ih,
                          self.bias_hh], name="simple_rnn_cell")
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size: int, hidden_size: int,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, proj_size: int = 0, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _make_weights(self, 4, input_size, hidden_size,
                      (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                       bias_hh_attr), _std_uniform(hidden_size))

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states

        def fn(x, h_, c_, wih, whh, bih, bhh):
            return _lstm_gates(x @ wih.T + bih + h_ @ whh.T + bhh, c_)

        h_new, c_new = apply_op(
            fn, [ensure_tensor(inputs), ensure_tensor(h), ensure_tensor(c),
                 self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh],
            name="lstm_cell")
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    def __init__(self, input_size: int, hidden_size: int,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _make_weights(self, 3, input_size, hidden_size,
                      (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                       bias_hh_attr), _std_uniform(hidden_size))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)

        def fn(x, h, wih, whh, bih, bhh):
            return _gru_gates(x @ wih.T + bih, h @ whh.T + bhh, h)

        h = apply_op(fn, [ensure_tensor(inputs), ensure_tensor(states),
                          self.weight_ih, self.weight_hh, self.bias_ih,
                          self.bias_hh], name="gru_cell")
        return h, h


class RNN(Layer):
    """A cell run over time, step by step (reference: ``RNN``)."""

    def __init__(self, cell, is_reverse: bool = False,
                 time_major: bool = False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        inputs = ensure_tensor(inputs)
        t_axis = 0 if self.time_major else 1
        T = inputs.shape[t_axis]
        states = initial_states
        outs = []
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        for t in steps:
            x_t = inputs[:, t] if t_axis == 1 else inputs[t]
            out, states = self.cell(x_t, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return stack(outs, axis=t_axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major: bool = False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = ((None, None) if initial_states is None
                        else initial_states)
        out_fw, fw_states = self.rnn_fw(inputs, st_fw)
        out_bw, bw_states = self.rnn_bw(inputs, st_bw)
        return concat([out_fw, out_bw], axis=-1), (fw_states, bw_states)


def _scan(mode, activation, seq, state, wih, whh, bih, bhh):
    """One layer and direction over ``seq`` ([T, B, I], in time order):
    ``(outputs [T, B, H], final state)``."""
    xproj = seq @ wih.T + bih
    act = _act(activation)
    ys = []
    for t in range(seq.shape[0]):
        if mode == "LSTM":
            h, c = state
            h, c = _lstm_gates(xproj[t] + h @ whh.T + bhh, c)
            state = (h, c)
        elif mode == "GRU":
            h = _gru_gates(xproj[t], state[0] @ whh.T + bhh, state[0])
            state = (h,)
        else:
            h = act(xproj[t] + state[0] @ whh.T + bhh)
            state = (h,)
        ys.append(h)
    return torch.stack(ys), state


class _RNNBase(Layer):
    """Multi-layer, optionally bidirectional recurrent network (module
    docstring)."""

    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction: str = "forward", time_major: bool = False,
                 dropout: float = 0.0, activation: str = "tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        num_dir = 2 if self.bidirect else 1
        gate_mult = {"RNN_TANH": 1, "RNN_RELU": 1, "LSTM": 4,
                     "GRU": 3}[self.MODE]
        init = _std_uniform(hidden_size)
        self._all_weights = []
        for layer in range(num_layers):
            for d in range(num_dir):
                in_sz = input_size if layer == 0 else hidden_size * num_dir
                suffix = "_reverse" if d == 1 else ""
                ws = [
                    self.create_parameter([gate_mult * hidden_size, in_sz],
                                          attr=weight_ih_attr,
                                          default_initializer=init),
                    self.create_parameter(
                        [gate_mult * hidden_size, hidden_size],
                        attr=weight_hh_attr, default_initializer=init),
                    self.create_parameter([gate_mult * hidden_size],
                                          attr=bias_ih_attr, is_bias=True,
                                          default_initializer=init),
                    self.create_parameter([gate_mult * hidden_size],
                                          attr=bias_hh_attr, is_bias=True,
                                          default_initializer=init)]
                for kind, w in zip(("weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh"), ws):
                    self.add_parameter(f"{kind}_l{layer}{suffix}", w)
                self._all_weights.append(tuple(ws))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        inputs = ensure_tensor(inputs)
        num_dir = 2 if self.bidirect else 1
        n_states = 2 if self.MODE == "LSTM" else 1
        mode, activation, time_major = (self.MODE, self.activation,
                                        self.time_major)
        num_layers, hidden = self.num_layers, self.hidden_size
        batch = inputs.shape[1 if time_major else 0]
        if initial_states is None:
            zeros = Tensor._wrap(torch.zeros(
                (num_layers * num_dir, batch, hidden), dtype=torch.float32,
                device=inputs._value.device))
            init_states = (zeros,) * n_states
        else:
            init_states = (initial_states
                           if isinstance(initial_states, (tuple, list))
                           else (initial_states,))
            init_states = tuple(ensure_tensor(s) for s in init_states)
        drop_p = (self.dropout if self.dropout > 0.0 and self.training
                  and num_layers > 1 else 0.0)

        def fn(x, *args):
            states, ws = args[:n_states], args[n_states:]
            out = x if time_major else x.transpose(0, 1)  # [T, B, I]
            final = [[] for _ in range(n_states)]
            for layer in range(num_layers):
                dir_outs = []
                for d in range(num_dir):
                    li = layer * num_dir + d
                    seq = out if d == 0 else out.flip(0)
                    ys, st = _scan(mode, activation, seq,
                                   tuple(s[li] for s in states),
                                   *ws[4 * li: 4 * li + 4])
                    dir_outs.append(ys if d == 0 else ys.flip(0))
                    for k in range(n_states):
                        final[k].append(st[k])
                out = torch.cat(dir_outs, -1) if num_dir == 2 else dir_outs[0]
                if drop_p and layer < num_layers - 1:
                    keep = _keep(out, drop_p, out.shape)
                    out = torch.where(keep, out / (1.0 - drop_p),
                                      0.0).to(out.dtype)
            if not time_major:
                out = out.transpose(0, 1)
            return (out,) + tuple(torch.stack(f, 0) for f in final)

        flat_w = [w for group in self._all_weights for w in group]
        res = apply_op(fn, [inputs, *init_states, *flat_w],
                       name=f"rnn_{mode.lower()}")
        if n_states == 2:
            out, h, c = res
            return out, (h, c)
        out, h = res
        return out, h


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        if activation == "relu":
            self.MODE = "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation, **kw)


class LSTM(_RNNBase):
    MODE = "LSTM"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kw)


class GRU(_RNNBase):
    MODE = "GRU"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kw)
