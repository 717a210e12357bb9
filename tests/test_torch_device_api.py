"""``paddle_tpu_torch.device`` (with ``device.cuda`` and ``device.xpu``),
the places and the small names of ``framework.core_api``, ``amp``'s
names, ``autograd.GradNode``, ``framework.save``/``load``,
``regularizer``, ``version`` and ``sysconfig``, against the JAX
package's. The card's side of ``device.cuda`` (streams, events, the
allocator's counters equal to ``torch.cuda``'s) runs in
``chip_smoke.py``; here the host without a card.

Exact comparisons throughout (names, states, raised types, integers),
but the regularized SGD step (1e-6: one f32 multiply-add).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

BOTH = (pt, paddle)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _outcome(fn, *args):
    """What a call gives: its value, or the type of what it raised."""
    try:
        return ("value", fn(*args))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raised", type(e).__name__)


def _guard(P):
    with P.device.cuda.stream_guard(None):
        return "entered"


def test_device_cuda_without_a_card_answers_as_the_jax_module(no_card):
    """The JAX module's CPU-build semantics: 0 devices, 0 bytes, nothing
    to empty, and ``ValueError`` from what needs a device."""
    assert paddle.device.cuda.__all__ == pt.device.cuda.__all__
    for name in pt.device.cuda.__all__:
        if name == "stream_guard":
            got = {P: _outcome(_guard, P) for P in BOTH}
        else:
            got = {P: _outcome(getattr(P.device.cuda, name)) for P in BOTH}
        assert got[paddle] == got[pt], name
    assert _outcome(paddle.device.cuda.device_count) == ("value", 0)
    assert _outcome(paddle.device.cuda.Stream) == ("raised", "ValueError")
    for P in BOTH:
        with pytest.raises(ValueError):
            P.device.xpu.synchronize()


def test_device_names_and_this_builds_answers():
    jnames = {n for n in dir(pt.device) if not n.startswith("_")} - {"jax"}
    assert jnames <= set(dir(paddle.device))
    d = paddle.device
    assert d.is_compiled_with_cuda() == (torch.version.cuda is not None)
    for fn in ("is_compiled_with_xpu", "is_compiled_with_ipu",
               "is_compiled_with_cinn", "is_compiled_with_rocm"):
        assert getattr(d, fn)() is getattr(pt.device, fn)() is False, fn
    assert d.is_compiled_with_custom_device() is False  # JAX: True (TPU)
    assert "cpu" in d.get_all_device_type()
    assert d.get_all_custom_device_type() == []
    assert d.get_available_custom_device() == []
    for P in BOTH:
        with pytest.raises(RuntimeError):
            P.device.IPUPlace()
        with pytest.raises(RuntimeError):
            P.device.XPUPlace(0)
    assert d.Stream is d.cuda.Stream and d.Event is d.cuda.Event
    assert d.stream_guard is d.cuda.stream_guard


def test_queries_follow_the_default_device(no_card):
    """Without a card the queries raise unless the device is the CPU,
    where memory is 0 and synchronize does nothing."""
    d = paddle.device
    prev = d._current
    d.set_device(None)
    try:
        for fn in (d.memory_allocated, d.memory_stats, d.synchronize):
            with pytest.raises(RuntimeError):
                fn()
    finally:
        d._current = prev
    paddle.set_device("cpu")
    assert d.memory_stats() == {}
    assert d.memory_allocated() == d.max_memory_allocated() == 0
    assert d.memory_reserved() == d.max_memory_reserved() == 0
    assert d.synchronize() is None
    assert d.get_all_devices() == [torch.device("cpu")]
    assert d.get_available_device() == ["cpu:0"]
    assert d.device_count() == 0 and d.device_count("cpu") == 1


def test_places_keep_the_jax_class_tree():
    for P in BOTH:
        assert issubclass(P.CUDAPlace, P.TPUPlace)
        assert issubclass(P.CUDAPinnedPlace, P.CPUPlace)
        assert P.CPUPlace() == P.CPUPlace()
        assert P.CUDAPlace(0).get_device_id() == 0
        assert P.CUDAPlace(0) != P.CUDAPlace(1)
        assert P.CUDAPlace(1) != P.TPUPlace(1)
        assert len({P.CUDAPlace(2), P.CUDAPlace(2), P.CPUPlace()}) == 2
    # in the port the accelerator is the card (JAX: "Place(tpu:0)")
    assert repr(paddle.CUDAPlace(0)) == "Place(gpu:0)"
    assert str(paddle.CUDAPlace(1)) == "gpu:1"
    assert str(paddle.CUDAPinnedPlace()) == "cpu"
    t = paddle.to_tensor([1.0, 2.0], place=paddle.CPUPlace())
    assert t._value.device.type == "cpu"


def test_small_names_of_core_api():
    def reader():
        yield from range(7)

    for P in BOTH:
        assert list(P.batch(reader, 3)()) == [[0, 1, 2], [3, 4, 5], [6]]
        assert list(P.batch(reader, 3, drop_last=True)()) == [
            [0, 1, 2], [3, 4, 5]]
        P.check_shape([2, 3, -1])
        P.check_shape([2, None])
        with pytest.raises(ValueError):
            P.check_shape([2, -5])
        with pytest.raises(TypeError):
            P.check_shape("nope")
        with pytest.raises(TypeError):
            P.check_shape([2, "x"])
        assert P.disable_signal_handler() is None
        with P.LazyGuard() as g:
            w = P.create_parameter([4, 5], "float32")
        assert isinstance(g, P.LazyGuard)
        assert tuple(w.shape) == (4, 5) and not w.stop_gradient
    assert paddle.ParamAttr is paddle.nn.ParamAttr
    assert paddle.loadgen.__name__ == "paddle_tpu_torch.loadgen"
    # this build's answers (the JAX package's TPU build: False, True, False)
    assert (pt.is_compiled_with_cuda(), pt.is_compiled_with_tpu(),
            pt.is_compiled_with_xpu()) == (False, True, False)
    assert (paddle.is_compiled_with_cuda(), paddle.is_compiled_with_tpu(),
            paddle.is_compiled_with_xpu()) == (
        torch.version.cuda is not None, False, False)


def test_set_printoptions_changes_repr_as_in_jax():
    x = np.asarray([[1.123456789, -2.5e-7, 3.0], [4.0, 5.5, 6.25]], "f4")
    saved = np.get_printoptions()
    try:
        for opts in (dict(precision=2), dict(precision=6, sci_mode=True),
                     dict(threshold=3, edgeitems=1, linewidth=40)):
            reprs = {}
            for P in BOTH:
                P.set_printoptions(**opts)
                reprs[P] = repr(P.to_tensor(x)).split("\n", 1)[1]
                np.set_printoptions(**saved)
            assert reprs[paddle] == reprs[pt], opts
    finally:
        np.set_printoptions(**saved)


def test_cuda_rng_state_round_trip():
    draws = {}
    for P in BOTH:
        P.seed(11)
        st = P.get_cuda_rng_state()
        a = np.asarray(P.rand([5]).numpy())
        P.set_cuda_rng_state(st)
        b = np.asarray(P.rand([5]).numpy())
        np.testing.assert_array_equal(a, b)
        draws[P] = a
    assert paddle.framework.core_api.get_cuda_rng_state().equal(
        paddle.get_rng_state())


def test_amp_names_and_grad_node():
    for P in BOTH:
        assert P.amp.white_list() == set(P.amp.WHITE_LIST)
        assert P.amp.amp_guard is P.amp.auto_cast
        assert P.amp.is_bfloat16_supported() is True
        assert isinstance(P.amp.is_float16_supported(), bool)
    assert paddle.amp.white_list() == pt.amp.white_list()
    assert paddle.amp.black_list() == pt.amp.black_list()
    st = {}
    for P in BOTH:
        outside = dict(P.amp.amp_state)
        with P.amp.auto_cast(level="O1", custom_black_list=["exp"]):
            inside = dict(P.amp.amp_state)
        st[P] = (outside["enabled"], outside["level"], inside["enabled"],
                 inside["level"], "bfloat16" in str(inside["dtype"]),
                 "exp" in inside["black"],
                 inside["white"] == frozenset(P.amp.white_list()))
    assert st[paddle] == st[pt]
    x = torch.ones(2, requires_grad=True)
    assert isinstance((x * 2).grad_fn, paddle.autograd.GradNode)
    assert "GradNode" in paddle.autograd.__all__


def test_framework_save_load(tmp_path):
    path = str(tmp_path / "obj.pdparams")
    paddle.framework.save({"w": paddle.to_tensor([1.0, 2.0]), "n": 3}, path)
    back = paddle.framework.load(path, device="cpu")
    assert back["n"] == 3
    np.testing.assert_array_equal(back["w"].numpy(), [1.0, 2.0])
    assert {"save", "load"} <= set(paddle.framework.__all__)


@pytest.mark.parametrize("decay", ["L2Decay", "L1Decay"])
def test_regularizer_applied_via_optimizer(decay):
    """The JAX test: a zero data gradient, so only the decay moves the
    weight; the same SGD step in both."""
    out = {}
    for P in BOTH:
        P.seed(0)
        lin = P.nn.Linear(2, 2, bias_attr=False)
        if P is paddle:
            lin.set_state_dict({"weight": w0})
        else:
            w0 = np.asarray(lin.weight.numpy()).copy()
        opt = P.optimizer.SGD(learning_rate=0.5, parameters=lin.parameters(),
                              weight_decay=getattr(P.regularizer, decay)(0.1))
        x = P.to_tensor(np.zeros((1, 2), np.float32))
        (lin(x).sum() * 0.0).backward()
        opt.step()
        out[P] = np.asarray(lin.weight.numpy())
    np.testing.assert_allclose(out[paddle], out[pt], rtol=1e-6, atol=1e-6)
    want = w0 - 0.5 * 0.1 * (w0 if decay == "L2Decay" else np.sign(w0))
    np.testing.assert_allclose(out[paddle], want, rtol=1e-6, atol=1e-6)


def test_version_and_sysconfig():
    v = paddle.version
    assert v.full_version.startswith("3.") and set(v.__all__) == set(
        pt.version.__all__)
    assert v.cuda() == (str(torch.version.cuda) if torch.version.cuda
                        else "False")
    assert v.xpu() == "False"
    inc = paddle.sysconfig.get_include()
    names = os.listdir(inc)
    assert "pd_inference_c.cc" in names and "flash_attention.cu" in names
    assert paddle.sysconfig.get_lib().endswith(
        os.path.join("build", "paddle_tpu_torch"))
