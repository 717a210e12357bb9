"""The port's DenseNet, GoogLeNet and InceptionV3 against the JAX
package's, on the CPU (``paddle_tpu_torch/vision/models/extra_nets.py``);
the rest of the zoo is in ``tests/test_torch_vision_zoo.py``.

- ``densenet121`` at 64 x 64, B 2, 10 classes, eval: its forward.
- ``googlenet`` in training (64 x 64, B 2, 6 classes): the output and
  both auxiliary heads, with its dropouts in eval in both packages (their
  masks come from each package's own generator); then in eval, its
  output alone.
- ``inception_v3`` at 75 x 75 (its smallest input), B 1, 5 classes,
  eval: its forward.

Tolerance: each array's largest difference within 1e-5 of its largest
magnitude (``twin(relative_to_max=True)``).
"""
import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import R, one_thread, state_of, twin  # noqa: F401

TOL = 1e-5


def test_densenet121_forward():
    tm = twin(lambda P: P.vision.models.densenet121(num_classes=10),
              [R(2, 3, 64, 64)], train=False, param_grads=False,
              grad_inputs=[False], relative_to_max=True)
    assert tm(paddle.to_tensor(R(2, 3, 64, 64))).shape == [2, 10]


def _close(b, a, what):
    diff, scale = np.abs(b - a).max(), np.abs(a).max()
    assert diff <= TOL * scale, (what, diff, scale)


def _run_googlenet(P, model, x):
    model.train()
    for layer in model.sublayers():
        if isinstance(layer, P.nn.Dropout):
            layer.eval()
    outs = [np.asarray(o.numpy()) for o in model(P.to_tensor(x))]
    model.eval()
    return outs, np.asarray(model(P.to_tensor(x)).numpy())


def test_googlenet_train_aux_heads():
    x = R(2, 3, 64, 64)
    pt.seed(0)
    jm = pt.vision.models.googlenet(num_classes=6)
    tm = paddle.vision.models.googlenet(num_classes=6)
    missing, unexpected = tm.set_state_dict(state_of(jm))
    assert not missing and not unexpected
    jo, je = _run_googlenet(pt, jm, x)
    to, te = _run_googlenet(paddle, tm, x)
    assert len(jo) == len(to) == 3
    for i, (a, b) in enumerate(zip(jo, to)):
        assert a.shape == b.shape == (2, 6)
        _close(b, a, f"output {i}")
    assert je.shape == te.shape == (2, 6)
    _close(te, je, "eval output")


def test_inception_v3_at_75():
    tm = twin(lambda P: P.vision.models.inception_v3(num_classes=5),
              [R(1, 3, 75, 75)], train=False, param_grads=False,
              grad_inputs=[False], relative_to_max=True)
    assert tm(paddle.to_tensor(R(1, 3, 75, 75))).shape == [1, 5]
