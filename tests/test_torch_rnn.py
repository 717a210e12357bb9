"""The port's recurrent layers against the JAX package's, on the CPU
(``paddle_tpu_torch/nn/layer/rnn.py``).

Each twin builds the layer in both packages, carries the JAX layer's
weights into the port's (``set_state_dict``), runs both on the same
seeded inputs and holds the outputs, the final states and the grads of
the inputs, the initial states and every parameter equal at f32 atol =
rtol = 1e-5 (``torch_nn_common.twin``):

- the cells (``SimpleRNNCell`` with tanh and relu, ``LSTMCell``,
  ``GRUCell``) given states, ``RNN`` forward and reverse with an initial
  state, ``BiRNN`` over LSTM cells with both initial states;
- 2-layer bidirectional ``SimpleRNN``, ``LSTM`` and ``GRU``, batch-major
  without initial states and time-major with them;
- ``sequence_length``, which both packages ignore: the padded rows'
  outputs and states are those of a call without it, in both
  (ROADMAP Queue 3);
- inter-layer dropout: twins at p = 0 in training; on the port, p = 0.5
  changes the training output and leaves the eval output alone, and a
  one-layer network never drops;
- under ``auto_cast`` O2 the outputs are bf16 in both.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import both, on_cpu  # noqa: F401
from torch_nn_common import R, one_thread, state_of, twin  # noqa: F401


class _WithStates:
    """A layer called as ``layer(x, states)`` from flat inputs: ``x``
    then the state arrays (grouped ``(h, c)`` for an LSTM-like layer, and
    ``((h, c), (h, c))`` for a BiRNN over LSTM cells)."""

    def __new__(cls, P, layer, group):
        class WithStates(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.inner = layer

            def forward(self, x, *states):
                return self.inner(x, group(states))
        return WithStates()


def _one(s):
    return s[0]


def _pair(s):
    return tuple(s)


def _two_pairs(s):
    return (s[0], s[1]), (s[2], s[3])


CELLS = {
    "SimpleRNNCell_tanh": (lambda P: P.nn.SimpleRNNCell(4, 6), 1, _one),
    "SimpleRNNCell_relu": (lambda P: P.nn.SimpleRNNCell(
        4, 6, activation="relu"), 1, _one),
    "LSTMCell": (lambda P: P.nn.LSTMCell(4, 6), 2, _pair),
    "GRUCell": (lambda P: P.nn.GRUCell(4, 6), 1, _one),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_with_states(name):
    make, n, group = CELLS[name]
    states = [R(3, 6, seed=10 + i) for i in range(n)]
    twin(lambda P: _WithStates(P, make(P), group), [R(3, 4)] + states)


def test_rnn_and_birnn_with_initial_states():
    for reverse in (False, True):
        twin(lambda P: _WithStates(P, P.nn.RNN(
            P.nn.GRUCell(4, 5), is_reverse=reverse), _one),
            [R(2, 6, 4), R(2, 5, seed=1)])
    twin(lambda P: _WithStates(P, P.nn.RNN(
        P.nn.LSTMCell(4, 5), time_major=True), _pair),
        [R(6, 2, 4), R(2, 5, seed=1), R(2, 5, seed=2)])
    twin(lambda P: _WithStates(P, P.nn.BiRNN(
        P.nn.LSTMCell(4, 5), P.nn.LSTMCell(4, 5)), _two_pairs),
        [R(2, 6, 4)] + [R(2, 5, seed=i) for i in range(1, 5)])


NETS = {"SimpleRNN": 1, "LSTM": 2, "GRU": 1}


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("net", sorted(NETS))
def test_two_layer_bidirectional(net, time_major):
    """Batch-major without initial states; time-major with them."""
    def make(P):
        return getattr(P.nn, net)(4, 5, num_layers=2, direction="bidirect",
                                  time_major=time_major)
    x = R(6, 3, 4) if time_major else R(3, 6, 4)
    if not time_major:
        twin(make, [x])
        return
    states = [R(4, 3, 5, seed=1 + i) for i in range(NETS[net])]
    twin(lambda P: _WithStates(P, make(P), _pair if NETS[net] == 2
                               else _one), [x] + states)


def test_sequence_length_is_ignored_in_both():
    """Rows padded past their length run on: the output with
    ``sequence_length`` is the output without it, in both packages."""
    x = R(3, 6, 4)
    x[1, 3:] = 0.0
    x[2, 5:] = 0.0
    lengths = np.array([6, 3, 5])

    class Lengths:
        def __new__(cls, P, net):
            class WithLengths(P.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.net = net

                def forward(self, x):
                    out, st = self.net(x, None, P.to_tensor(lengths))
                    plain, st2 = self.net(x)
                    return out, st, plain, st2
            return WithLengths()

    lstm = twin(lambda P: Lengths(P, P.nn.LSTM(4, 5, 2, "bidirect")), [x])
    rnn = twin(lambda P: Lengths(P, P.nn.BiRNN(P.nn.GRUCell(4, 5),
                                               P.nn.GRUCell(4, 5))), [x])
    for layer in (lstm, rnn):
        out, st, plain, _ = layer(paddle.to_tensor(x))
        np.testing.assert_array_equal(out.numpy(), plain.numpy())
        # the padded row's last output is not its output at its length
        assert not np.allclose(out.numpy()[1, -1], out.numpy()[1, 2])


def test_dropout_between_layers_only_in_training():
    x = R(3, 6, 4)
    # p = 0: twins in training
    twin(lambda P: P.nn.GRU(4, 5, 2, dropout=0.0), [x])
    paddle.seed(3)
    lstm = paddle.nn.LSTM(4, 5, 2, dropout=0.5)
    plain = paddle.nn.LSTM(4, 5, 2)
    plain.set_state_dict(state_of(lstm))
    xt = paddle.to_tensor(x)
    dropped = lstm(xt)[0].numpy()
    assert not np.allclose(dropped, plain(xt)[0].numpy())
    lstm.eval()
    np.testing.assert_array_equal(lstm(xt)[0].numpy(), plain(xt)[0].numpy())
    one = paddle.nn.GRU(4, 5, 1, dropout=0.5)
    ref = paddle.nn.GRU(4, 5, 1)
    ref.set_state_dict(state_of(one))
    np.testing.assert_array_equal(one(xt)[0].numpy(), ref(xt)[0].numpy())


def test_o2_outputs_are_bf16():
    x = R(2, 5, 4)

    def case(P):
        pt.seed(0)
        net = P.nn.LSTM(4, 5, 2, "bidirect")
        if P is pt:
            case.w = state_of(net)
        else:
            net.set_state_dict(case.w)
        with P.amp.auto_cast(level="O2", dtype="bfloat16"):
            out, (h, c) = net(P.to_tensor(x))
        return out, h, c
    got = both(case, 2e-2)
    assert [g[1] for g in got] == ["bfloat16"] * 3
