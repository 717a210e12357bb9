"""The port's ``nn.functional`` extended ops and ``nn`` extended layers
against the JAX package's (``paddle_tpu/nn/{functional,layer}/
extended.py``), on the CPU.

Each functional case of ``paddle_tpu_torch/tools/extended_cases.py``
(which ``chip_smoke.py`` also runs on the card) runs in both packages on
the same seeded inputs: outputs, dtypes and input grads at f32 atol =
rtol = 1e-5 (``torch_extended_common.check_case``). ``grid_sample`` and
``affine_grid`` are held to the reference with samples on the border
(±1), between it and the pixel centres, and outside, in every padding
mode and both ``align_corners``. The layers' twins are the ``EXTENDED``
cases of ``tests/torch_nn_cases.py`` (``test_layer_twin``); beam search
runs here through both packages on one cell.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.tools.extended_cases import CASES, LINALG
from torch_extended_common import check_case
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import one_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(set(CASES) - set(LINALG)))
def test_case(name):
    check_case(name)


def test_rnnt_loss_equals_the_numpy_recursion():
    """The transducer NLL against a direct numpy forward recursion
    (``tests/test_nn_tail.py``'s reference), grads finite."""
    rng = np.random.default_rng(0)
    B, T, U, V = 2, 4, 3, 5
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U))

    def ref_one(a, lab):
        lp = a - np.log(np.exp(a).sum(-1, keepdims=True))
        alpha = np.full((T, U + 1), -np.inf)
        alpha[0, 0] = 0.0
        for ti in range(T):
            for u in range(U + 1):
                if ti == 0 and u == 0:
                    continue
                c = []
                if ti > 0:
                    c.append(alpha[ti - 1, u] + lp[ti - 1, u, 0])
                if u > 0:
                    c.append(alpha[ti, u - 1] + lp[ti, u - 1, lab[u - 1]])
                alpha[ti, u] = np.logaddexp.reduce(c)
        return -(alpha[T - 1, U] + lp[T - 1, U, 0])

    want = np.mean([ref_one(logits[b], labels[b]) for b in range(B)])
    lg = paddle.to_tensor(logits, stop_gradient=False)
    loss = paddle.nn.functional.rnnt_loss(
        lg, paddle.to_tensor(labels), paddle.to_tensor(np.full(B, T)),
        paddle.to_tensor(np.full(B, U)))
    np.testing.assert_allclose(float(loss.numpy()), want, rtol=1e-5)
    loss.backward()
    assert np.isfinite(lg.grad.numpy()).all()


def test_refusals_equal_the_jax_package():
    x = np.zeros((1, 1, 2, 2), "f4")
    g = np.zeros((1, 1, 1, 2), "f4")
    for P in (pt, paddle):
        F = P.nn.functional
        with pytest.raises(NotImplementedError, match="fastemit"):
            F.rnnt_loss(P.to_tensor(np.zeros((1, 2, 2, 3), "f4")),
                        P.to_tensor(np.array([[1]])),
                        P.to_tensor(np.array([2])), P.to_tensor(np.array([1])),
                        fastemit_lambda=0.1)
        with pytest.raises(ValueError, match="mode"):
            F.grid_sample(P.to_tensor(x), P.to_tensor(g), mode="bicubic")
        with pytest.raises(ValueError, match="padding_mode"):
            F.grid_sample(P.to_tensor(x), P.to_tensor(g),
                          padding_mode="wrap")
        with pytest.raises(ValueError, match="data_format"):
            F.temporal_shift(P.to_tensor(x), 1, data_format="CHWN")
        with pytest.raises(ValueError, match="CHW or NCHW"):
            P.nn.Softmax2D()(P.to_tensor(np.zeros((2, 3), "f4")))
        with pytest.raises(ValueError, match="num_classes"):
            P.nn.HSigmoidLoss(4, 1)


def test_elu_in_place_writes_the_tensor():
    x = paddle.to_tensor(np.array([-1.0, 2.0], "f4"))
    out = paddle.nn.functional.elu_(x, 0.5)
    assert out is x
    np.testing.assert_allclose(x.numpy(), [0.5 * np.expm1(-1.0), 2.0],
                               rtol=1e-6)


def _chain_cell(P, V=6):
    """A deterministic cell: the next token after ``i`` is ``i + 1`` with
    a runner-up at ``i + 2`` whose margin grows with ``i`` (no two paths
    tie); states pass through."""
    def cell(inputs, states):
        tok = np.asarray(inputs.numpy()).astype(np.int64)
        logits = np.full((tok.shape[0], V), -5.0, np.float32)
        for r, tk in enumerate(tok):
            logits[r, min(tk + 1, V - 1)] = 5.0
            logits[r, min(tk + 2, V - 1)] = 4.0 - 0.3 * tk
        return P.to_tensor(logits), states
    return cell


@pytest.mark.parametrize("beam,batch", [(2, 1), (3, 2)])
def test_beam_search_equals_the_jax_package(beam, batch):
    got = {}
    for P in (pt, paddle):
        dec = P.nn.BeamSearchDecoder(_chain_cell(P), start_token=0,
                                     end_token=4, beam_size=beam)
        ids, probs = P.nn.dynamic_decode(
            dec, inits={"h": np.zeros((batch, 3), "f4")}, max_step_num=10,
            batch_size=batch)
        got[P.__name__] = (np.asarray(ids.numpy()), np.asarray(probs.numpy()))
    (ji, jp), (ti, tp) = got["paddle_tpu"], got["paddle_tpu_torch"]
    assert ti.shape == ji.shape and ti.shape[:2] == (batch, beam)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)
    best = ti[0, 0]
    end = np.nonzero(best == 4)[0][0]
    np.testing.assert_array_equal(best[:end + 1], [1, 2, 3, 4])
    assert np.all(best[end:] == 4)


def test_beam_search_gathers_the_states_by_source_beam():
    """States follow the beam they came from: a state that counts the
    steps of its own beam comes back gathered per winner."""
    V = 5

    def cell(inputs, states):
        n = paddle.to_tensor(states["n"]) + 1.0
        tok = inputs.numpy()
        logits = np.where(np.arange(V)[None, :] == (tok[:, None] + 1) % V,
                          2.0, 0.0).astype("f4")
        return paddle.to_tensor(logits), {"n": n}

    dec = paddle.nn.BeamSearchDecoder(cell, start_token=0, end_token=4,
                                      beam_size=2)
    tokens, states, probs, finished = dec.initialize(
        {"n": np.zeros((1, 1), "f4")}, 1)
    assert states["n"].shape == (2, 1) and probs.tolist() == [0.0, -1e9]
    for step in range(3):
        tokens, states, probs, finished, src = dec.step(
            tokens, states, probs, finished, 1)
        assert states["n"].tolist() == [[step + 1.0]] * 2
    assert tokens.tolist()[0] == 3
