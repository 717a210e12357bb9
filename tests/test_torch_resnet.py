"""The port's ResNet family against the JAX package's, on the CPU
(``paddle_tpu_torch/vision/models/resnet.py``); its training is in
``tests/test_torch_resnet_train.py``.

- ``state_dict`` names and shapes are equal (resnet18, resnet50), the
  BatchNorms' running statistics included, so weights carry across as
  they are (``set_state_dict``, strict).
- ``resnet18`` and a Bottleneck ``ResNet`` (depth 50) at 32 x 32, B 2,
  10 classes, in eval: forward, the input's grad and every parameter's
  grad at f32 atol = rtol = 1e-5 (``torch_nn_common.twin``).
- ``tests/test_vision.py``'s ResNet cases (``resnet18``, ``resnet50``,
  ``resnext50_32x4d``, ``wide_resnet50_2``; 64 x 64, B 2, 10 classes,
  eval) as twins of their forward, at 1e-5.
- ``pretrained=True`` raises in both.
"""
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import R, one_thread, state_of, twin  # noqa: F401


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_state_dict_names_and_shapes(name):
    jm = getattr(pt.vision.models, name)(num_classes=10)
    tm = getattr(paddle.vision.models, name)(num_classes=10)
    assert _shapes(jm) == _shapes(tm)
    assert sum(k.endswith("_mean") for k in _shapes(tm)) == (
        20 if name == "resnet18" else 53)
    missing, unexpected = tm.set_state_dict(state_of(jm))
    assert not missing and not unexpected


def _make(name):
    def make(P):
        M = P.vision.models
        if name == "resnet18":
            return M.resnet18(num_classes=10)
        return M.ResNet(M.BottleneckBlock, 50, num_classes=10)
    return make


@pytest.mark.parametrize("name", ["resnet18", "bottleneck50"])
def test_forward_and_grads_eval(name):
    twin(_make(name), [R(2, 3, 32, 32)], train=False)


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnext50_32x4d",
                                  "wide_resnet50_2"])
def test_vision_zoo_forward(name):
    """``tests/test_vision.py::TestModelZoo::test_forward_shape``'s ResNet
    cases, as twins."""
    def make(P):
        return getattr(P.vision.models, name)(num_classes=10)
    tm = twin(make, [R(2, 3, 64, 64)], train=False, param_grads=False,
              grad_inputs=[False])
    assert tm(paddle.to_tensor(R(2, 3, 64, 64))).shape == [2, 10]


def test_pretrained_raises():
    for P in (pt, paddle):
        with pytest.raises(NotImplementedError):
            P.vision.models.resnet50(pretrained=True)
