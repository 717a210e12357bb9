"""ResNet training in the port against the JAX package's, on the CPU
(batch statistics, the bench's optimizer, O2), as
``tests/test_torch_resnet.py`` holds the forward in eval.

In training each BatchNorm normalises by its batch's statistics, which
amplify the two packages' f32 summation-order differences (their convs
sum in different orders): a 1e-7 difference in a channel whose few
values lie close together comes out ~1/sqrt(eps) = 316 times larger.
So these twins hold each output and gradient to ``1e-4`` of the array's
largest magnitude (``twin(..., relative_to_max=True)``), at sizes where
every BatchNorm sees at least 8 values a channel:

- a ``BasicBlock`` pair and a ``BottleneckBlock`` pair (strided, with a
  projection; the Bottleneck grouped as a ResNeXt block is) at 8 x 8,
  B 4, and ``resnet18`` at 32 x 32, B 8: forward, the input's grad and
  every parameter's grad;
- the depth-50 Bottleneck net in training at 32 x 32, B 8: its output
  at 1e-3 of its largest value. Its gradients are chaotic at random
  init: the JAX package against itself, the input moved by one part in
  1e7, differs by up to ~10% of a gradient's largest value;
- three ``Momentum(0.1, 0.9)`` steps of ``resnet18`` in f32 at 32 x 32,
  B 8: the losses at rtol 1e-4, every parameter and running statistic
  within 5e-2 of its largest magnitude and the median array within 1e-3
  (the test's docstring says why);
- ``jit.StaticFunction`` equals the eager step on the CPU, bit for bit;
- O2: ``amp.decorate`` keeps the BatchNorms' parameters and statistics
  f32 and casts the rest to bf16, and under ``auto_cast`` O2 each
  sublayer's output dtype is the reference's: every BatchNorm f32, and
  the convs, ReLUs, pools, blocks and classifier bf16 (ReLU and the
  residual add are on neither amp list, so O2 casts the f32 BatchNorm
  output back to bf16 at them); three steps at lr 0.01 train (the loss
  falls) in both, the first loss within 1e-2.
"""
import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import (R, fresh_uids, one_thread,  # noqa: F401
                             state_of, twin)

TRAIN_TOL = 1e-4


def _blocks(kind):
    def make(P):
        M, nn = P.vision.models, P.nn
        if kind == "basic":
            ds = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2, bias_attr=False),
                               nn.BatchNorm2D(16))
            return nn.Sequential(M.BasicBlock(8, 16, 2, ds),
                                 M.BasicBlock(16, 16))
        ds = nn.Sequential(nn.Conv2D(8, 32, 1, stride=2, bias_attr=False),
                           nn.BatchNorm2D(32))
        return nn.Sequential(
            M.BottleneckBlock(8, 8, 2, ds, groups=2, base_width=32),
            M.BottleneckBlock(32, 8, groups=2, base_width=32))
    return make


def test_blocks_in_training():
    for kind in ("basic", "bottleneck"):
        twin(_blocks(kind), [R(4, 8, 8, 8)], TRAIN_TOL,
             relative_to_max=True)


def test_resnet18_in_training():
    twin(lambda P: P.vision.models.resnet18(num_classes=10),
         [R(8, 3, 32, 32)], TRAIN_TOL, relative_to_max=True)


def test_bottleneck50_forward_in_training():
    twin(lambda P: P.vision.models.ResNet(P.vision.models.BottleneckBlock,
                                          50, num_classes=10),
         [R(8, 3, 32, 32)], 1e-3, param_grads=False, grad_inputs=[False],
         relative_to_max=True)


def _momentum_run(P, weights, lr=0.1, level=None, steps=3):
    """``steps`` bench-style steps (``Momentum(lr, 0.9)``, cross entropy;
    O2 bf16 when ``level``) of ``resnet18`` from ``weights`` at 32 x 32,
    B 8: the losses and the final state (parameters and running
    statistics)."""
    model = P.vision.models.resnet18(num_classes=10)
    if P is pt:
        fresh_uids(model)
    model.set_state_dict(weights)
    opt = P.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                               parameters=model.parameters())
    if level:
        model, opt = P.amp.decorate(model, opt, level=level,
                                    dtype="bfloat16")
    rng = np.random.default_rng(0)
    x = P.to_tensor(rng.standard_normal((8, 3, 32, 32)).astype("f4"))
    y = P.to_tensor(rng.integers(0, 10, (8,)))
    losses = []
    for _ in range(steps):
        with P.amp.auto_cast(enable=level is not None, level=level or "O1",
                             dtype="bfloat16"):
            loss = P.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(np.asarray(loss.numpy(), "f4")))
    return losses, {k: np.asarray(v.numpy(), "f4")
                    for k, v in model.state_dict().items()}


def _weights():
    pt.seed(0)
    return state_of(pt.vision.models.resnet18(num_classes=10))


def test_three_momentum_steps_f32():
    """The bench's optimizer and lr: the losses (4.2, 9.3, 8.8 in both:
    the step-2 update overshoots) at rtol 1e-4; every parameter and
    running statistic within 5e-2 of its largest magnitude, the median
    array within 1e-3. Three steps carry the first step's 1e-5 gradient
    differences through 20 batch-statistic BatchNorms: the JAX package
    against itself, its weights moved by one part in 1e7, ends ~2% apart
    on its most sensitive arrays (the BatchNorm biases)."""
    w = _weights()
    jl, js = _momentum_run(pt, w)
    tl, ts = _momentum_run(paddle, w)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert js.keys() == ts.keys()
    ratios = {k: np.abs(ts[k] - js[k]).max() / np.abs(js[k]).max()
              for k in js}
    assert max(ratios.values()) <= 5e-2, max(ratios.items(),
                                             key=lambda kv: kv[1])
    assert np.median(list(ratios.values())) <= 1e-3
    moved = [k for k in js if k.endswith(("_mean", "_variance"))
             and not np.allclose(js[k], w[k])]
    assert len(moved) == 40


def test_static_function_equals_eager_on_cpu():
    from paddle_tpu_torch import bench, jit

    runs = []
    for graphed in (False, True):
        model, opt = bench.build("resnet18", "cpu", None)
        fn = bench.make_resnet_train_fn(model, opt)
        step = jit.StaticFunction(fn, observe=[model, opt]) if graphed \
            else fn
        args = bench.resnet_data(2, 32, "cpu")
        losses = [float(step(*args)) for _ in range(3)]
        runs.append((losses, state_of(model)))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][k], v, err_msg=k)
    assert step.compile_counts() == {"signatures": 1, "captured": 1,
                                     "calls": 3}


def _dtypes_under_o2(P, weights):
    """Each sublayer's output dtype (by name) in one O2 forward, after
    ``amp.decorate``; and the parameters' and buffers' dtypes."""
    model = P.vision.models.resnet18(num_classes=10)
    model.set_state_dict(weights)
    model = P.amp.decorate(model, level="O2", dtype="bfloat16")
    seen = {}

    def hook(name):
        def record(layer, inputs, out):
            seen.setdefault(name, str(out.dtype).split(".")[-1])
        return record

    for name, layer in model.named_sublayers():
        layer.register_forward_post_hook(hook(name))
    with P.amp.auto_cast(level="O2", dtype="bfloat16"):
        out = model(P.to_tensor(R(2, 3, 32, 32)))
    state = {k: str(v.dtype).split(".")[-1]
             for k, v in model.state_dict().items()}
    return seen, state, str(out.dtype).split(".")[-1]


def test_o2_keeps_batchnorm_f32_and_the_reference_dtypes():
    w = _weights()
    jseen, jstate, jout = _dtypes_under_o2(pt, w)
    tseen, tstate, tout = _dtypes_under_o2(paddle, w)
    assert tseen == jseen and tstate == jstate and tout == jout == "bfloat16"
    bns = {k: v for k, v in tseen.items()
           if "bn" in k or k.endswith("downsample.1")}
    assert len(bns) == 20 and set(bns.values()) == {"float32"}
    assert tseen["relu"] == tseen["layer1.0"] == tseen["maxpool"] == \
        tseen["layer1.0.conv1"] == tseen["avgpool"] == "bfloat16"
    assert all(v == "float32" for k, v in tstate.items()
               if "bn" in k or "downsample.1" in k)
    assert tstate["conv1.weight"] == tstate["fc.weight"] == "bfloat16"


def test_o2_trains_in_both():
    w = _weights()
    jl, _ = _momentum_run(pt, w, lr=0.01, level="O2")
    tl, _ = _momentum_run(paddle, w, lr=0.01, level="O2")
    assert tl[2] < tl[0] and jl[2] < jl[0], (tl, jl)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-2)
