"""The port's ``jit.BucketedFunction`` and its helpers against the JAX
package's (``paddle_tpu_torch/jit/bucketing.py``), on the CPU: the four
cases of ``tests/test_bucketing.py`` as twins.

- ``pow2_buckets`` and ``bucket_for`` give the same ladders and buckets,
  and both raise past the ladder.
- ``pad_to_bucket`` pads to the same values exactly (a facade Tensor
  stays one, on its device; a torch tensor and a numpy array pad too).
- On the same 19 (batch, seq) shapes, ``compile_count`` equals the JAX
  one and stays within ``max_programs``; each call's value equals the
  JAX one exactly (integers summed in f32).
- A bucketed cross entropy with ignore-label padding equals the unpadded
  loss in both packages (rtol 1e-5), and the two packages' values agree
  at rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import one_thread  # noqa: F401


@pytest.mark.parametrize("lo,hi", [(24, 100), (1, 8), (5, 5), (100, 1000)])
def test_pow2_buckets(lo, hi):
    assert paddle.jit.pow2_buckets(lo, hi) == pt.jit.pow2_buckets(lo, hi)


def test_bucket_for():
    for size in (1, 31, 32, 33, 64, 128):
        assert paddle.jit.bucket_for(size, [128, 32, 64]) == \
            pt.jit.bucket_for(size, [128, 32, 64])
    for P in (pt, paddle):
        with pytest.raises(ValueError):
            P.jit.bucket_for(200, [32, 64, 128])


def test_pad_to_bucket_values():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    jp, jo = pt.jit.pad_to_bucket(pt.to_tensor(x), axis=1, buckets=[4, 8],
                                  pad_value=-1.0)
    tp, to = paddle.jit.pad_to_bucket(paddle.to_tensor(x), axis=1,
                                      buckets=[4, 8], pad_value=-1.0)
    assert isinstance(tp, paddle.Tensor) and to == jo == 3
    assert tp.shape == jp.shape == [2, 4] and tp.place == "cpu"
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    # a torch tensor and an array pad the same, on two dims at once
    from paddle_tpu.jit.bucketing import _pad_multi as jax_pad
    from paddle_tpu_torch.jit.bucketing import _pad_multi

    ids = np.arange(15).reshape(3, 5)
    want, jsizes = jax_pad(ids, {0: [4], 1: [8, 16]}, pad_value=7)
    for src in (ids, torch.from_numpy(ids)):
        got, sizes = _pad_multi(src, {0: [4], 1: [8, 16]}, pad_value=7)
        assert isinstance(got, torch.Tensor) and sizes == jsizes
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same, _ = paddle.jit.pad_to_bucket(tp, axis=0, buckets=[2])
    assert same is tp  # already on its bucket: no pad


def test_bounded_recompilation_under_varying_shapes():
    """19 calls with varying (batch, seq): the same programs as the JAX
    package's, at most the product of the ladders."""
    bladder, sladder = [4, 8], [16, 32, 64]

    def step_of(P):
        def step(ids):
            return (ids.astype("float32") * 2).sum()
        return P.jit.BucketedFunction(step,
                                      axes={0: {0: bladder, 1: sladder}})

    jstep, tstep = step_of(pt), step_of(paddle)
    rng = np.random.RandomState(0)
    shapes = [(b, s) for b in (1, 3, 4, 5, 8) for s in (9, 16, 17, 33)][:19]
    for b, s in shapes:
        ids = rng.randint(0, 100, (b, s))
        want = np.asarray(jstep(pt.to_tensor(ids)).numpy())
        got = tstep(paddle.to_tensor(ids))
        assert isinstance(got, paddle.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)
    assert tstep.compile_count == jstep.compile_count
    assert tstep.compile_count <= tstep.max_programs() == \
        jstep.max_programs() == len(bladder) * len(sladder)
    assert tstep.compile_count < len(shapes)


def test_bucketed_train_step_with_label_padding():
    """Labels padded with the ignore value: the bucketed loss over (5, V)
    equals the unpadded loss."""
    V = 16
    rng = np.random.RandomState(1)
    logits = rng.randn(5, V).astype(np.float32)
    labels = rng.randint(0, V, (5,))
    values = {}
    for P in (pt, paddle):
        def loss_fn(lg, lb, F=P.nn.functional):
            return F.cross_entropy(lg, lb, ignore_index=-100)

        plain = float(np.asarray(loss_fn(P.to_tensor(logits),
                                         P.to_tensor(labels)).numpy()))
        bl = P.jit.BucketedFunction(loss_fn, axes={0: {0: [8]}, 1: {0: [8]}},
                                    pad_values={1: -100})
        bucketed = float(np.asarray(bl(P.to_tensor(logits),
                                       P.to_tensor(labels)).numpy()))
        np.testing.assert_allclose(bucketed, plain, rtol=1e-5)
        values[P.__name__] = bucketed
    np.testing.assert_allclose(values["paddle_tpu_torch"],
                               values["paddle_tpu"], rtol=1e-5)


def test_jit_false_calls_the_function_on_padded_args():
    seen = []
    bf = paddle.jit.BucketedFunction(lambda a: seen.append(a.shape) or a,
                                     axes={0: {1: [4, 8]}}, jit=False)
    bf(paddle.to_tensor(np.zeros((2, 5), "float32")))
    assert seen == [[2, 8]] and bf.compile_count == 0
