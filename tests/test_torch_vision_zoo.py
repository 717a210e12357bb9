"""The port's classification zoo against the JAX package's, on the CPU
(``paddle_tpu_torch/vision/models/simple_nets.py``, ``mobilenet.py``,
``extra_nets.py``); DenseNet, GoogLeNet and InceptionV3 are in
``tests/test_torch_vision_zoo_deep.py``.

- ``state_dict`` names and shapes equal the JAX model's, BatchNorm
  running statistics included, so weights carry across as they are
  (``set_state_dict``, strict): every twin below carries them, and two
  variants without a twin (VGG with BatchNorm, the swish ShuffleNet) are
  compared alone.
- ``tests/test_vision.py::TestModelZoo``'s constructors outside ResNet
  (64 x 64, B 2, 10 classes, eval) as twins of their forward, plus
  ``LeNet`` (1 x 28 x 28) and ``alexnet``. ``mobilenet_v3_small`` and
  ``shufflenet_v2_x0_25`` also hold the input's grad and every
  parameter's grad. Tolerance: each array's largest difference within
  1e-5 of its largest magnitude (``twin(relative_to_max=True)``; random
  deep nets give outputs of 1e-11 to 1e-2, too small for an absolute
  limit).
- ``pretrained=True`` raises in both.
"""
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import R, one_thread, state_of, twin  # noqa: F401


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _build(P, name, **kw):
    return getattr(P.vision.models, name)(**kw)


@pytest.mark.parametrize("name,kw", [
    ("vgg11", {"batch_norm": True}), ("shufflenet_v2_swish", {})])
def test_state_dict_names_and_shapes(name, kw):
    jm = _build(pt, name, num_classes=10, **kw)
    tm = _build(paddle, name, num_classes=10, **kw)
    assert _shapes(jm) == _shapes(tm)
    missing, unexpected = tm.set_state_dict(state_of(jm))
    assert not missing and not unexpected
    if name == "vgg11":
        assert sum(k.endswith("_variance") for k in _shapes(tm)) == 8


@pytest.mark.parametrize("name", ["mobilenet_v1", "mobilenet_v2", "vgg11",
                                  "squeezenet1_1", "alexnet"])
def test_zoo_forward_eval(name):
    """``TestModelZoo::test_forward_shape``'s cases, as twins."""
    tm = twin(lambda P: _build(P, name, num_classes=10), [R(2, 3, 64, 64)],
              train=False, param_grads=False, grad_inputs=[False],
              relative_to_max=True)
    assert tm(paddle.to_tensor(R(2, 3, 64, 64))).shape == [2, 10]


@pytest.mark.parametrize("name", ["mobilenet_v3_small",
                                  "shufflenet_v2_x0_25"])
def test_zoo_forward_and_grads_eval(name):
    twin(lambda P: _build(P, name, num_classes=10), [R(2, 3, 64, 64)],
         train=False, relative_to_max=True)


def test_lenet():
    twin(lambda P: P.vision.models.LeNet(), [R(2, 1, 28, 28)], train=False,
         relative_to_max=True)


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "squeezenet1_0",
                                  "mobilenet_v3_large", "densenet121",
                                  "shufflenet_v2_x1_0", "googlenet",
                                  "inception_v3"])
def test_pretrained_raises(name):
    for P in (pt, paddle):
        with pytest.raises(NotImplementedError):
            _build(P, name, pretrained=True)


def test_shufflenet_rejects_unknown_act():
    for P in (pt, paddle):
        with pytest.raises(ValueError):
            P.vision.models.ShuffleNetV2(scale=0.25, act="gelu")
