"""``paddle_tpu_torch.inference`` against the JAX package's: ``Config``,
``Predictor`` and the ``PD_*`` C API (``csrc/pd_inference_c.cc``, built
here with the host compiler), on the CPU.

- The JAX test file's cases (``tests/test_inference.py``) run on both
  packages over the same weights: model resolution, the empty config,
  the predictor against the eager net (2e-5 rtol, 1e-6 atol, as there),
  positional runs, a dynamic batch, the unset input, the C API end to
  end; the port's outputs equal the JAX package's at the same tolerance.
- The 2-layer narrow GPT: ``jit.save`` -> ``Predictor`` -> C API, each
  bit for bit the port's eager logits, within 1e-5 of the JAX package's
  (f32, as ``tests/test_torch_gpt.py``); after
  ``convert_to_mixed_precision`` to bf16 storage the weights are the
  bf16 roundings and the logits those of the model with rounded weights.
- The enums, version and size queries, ``PredictorPool`` and
  ``_get_phi_kernel_name`` equal the JAX package's.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     load_reference_state_dict)
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

BOTH = (pt, paddle)
RTOL, ATOL = 2e-5, 1e-6


def _net(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = P.nn.Linear(8, 16)
            self.fc2 = P.nn.Linear(16, 3)

        def forward(self, x):
            return self.fc2(P.nn.functional.relu(self.fc1(x)))

    return Net()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("infer")
    pt.seed(7)
    jnet = _net(pt)
    paddle.set_device("cpu")
    try:
        tnet = _net(paddle)
        tnet.set_state_dict({k: np.asarray(v.numpy())
                             for k, v in jnet.state_dict().items()})
    finally:
        paddle.set_device(None)
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    out = {}
    for P, net in ((pt, jnet), (paddle, tnet)):
        prefix = str(d / P.__name__ / "net")
        P.jit.save(net, prefix, input_spec=[
            P.jit.InputSpec([None, 8], "float32", name="feats")])
        xt = (paddle.to_tensor(x, place="cpu") if P is paddle
              else pt.to_tensor(x))
        out[P] = (prefix, np.asarray(net(xt).numpy()))
    return out, x


def _cfg(P, prefix):
    cfg = P.inference.Config()
    cfg.set_model(prefix)
    cfg.disable_gpu()
    return cfg


def test_config_model_resolution(saved, tmp_path):
    out, _ = saved
    for P in BOTH:
        prefix = out[P][0]
        cfg = P.inference.Config()
        cfg.set_model(prefix)
        assert cfg.model_prefix() == prefix
        cfg2 = P.inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
        assert cfg2.model_prefix() == prefix
        assert cfg2.prog_file() == prefix + ".pdmodel"
        d = str(tmp_path / P.__name__)
        os.makedirs(d)
        for suf in (".pdmodel", ".pdiparams"):
            with open(prefix + suf, "rb") as fsrc, \
                    open(os.path.join(d, "m" + suf), "wb") as fdst:
                fdst.write(fsrc.read())
        cfg3 = P.inference.Config()
        cfg3.set_model(d)
        assert cfg3.model_prefix() == os.path.join(d, "m")
        assert cfg.use_gpu()  # the accelerator by default in both
        cfg.disable_gpu()
        assert not cfg.use_gpu()
        cfg.enable_use_gpu(100, 0)
        assert cfg.use_gpu()
        assert "model_prefix" in cfg.summary()
        with pytest.raises(ValueError, match="no model location"):
            P.inference.create_predictor(P.inference.Config())


def test_predictor_matches_eager_and_the_jax_predictor(saved):
    out, x = saved
    res = {}
    for P in BOTH:
        prefix, expect = out[P]
        pred = P.inference.create_predictor(_cfg(P, prefix))
        assert pred.get_input_names() == ["feats"]
        h = pred.get_input_handle("feats")
        h.reshape(x.shape)
        h.copy_from_cpu(x)
        (o,) = pred.run()
        np.testing.assert_allclose(o, expect, rtol=RTOL, atol=ATOL)
        assert pred.get_output_names() == ["out0"]
        oh = pred.get_output_handle("out0")
        np.testing.assert_allclose(oh.copy_to_cpu(), expect, rtol=RTOL,
                                   atol=ATOL)
        assert oh.shape() == [4, 3]
        x2 = np.random.default_rng(1).standard_normal((9, 8)).astype("f4")
        (o2,) = pred.run([x2])
        assert o2.shape == (9, 3)
        with pytest.raises(KeyError):
            pred.get_input_handle("nope")
        (o3,) = P.inference.create_predictor(_cfg(P, prefix)).run([x])
        res[P] = (o, o2, o3)
        with pytest.raises(RuntimeError, match="not set"):
            P.inference.create_predictor(_cfg(P, prefix)).run()
    assert res[paddle][0].tobytes() == out[paddle][1].tobytes()
    for a, b in zip(res[paddle], res[pt]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _capi():
    from paddle_tpu_torch.ops._build import load_host

    lib = load_host("pd_inference_c")
    lib.PD_Init.restype = ctypes.c_int
    lib.PD_Init.argtypes = [ctypes.c_char_p]
    lib.PD_GetLastError.restype = ctypes.c_char_p
    lib.PD_PredictorCreate.restype = ctypes.c_int64
    lib.PD_PredictorCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.PD_PredictorDestroy.argtypes = [ctypes.c_int64]
    lib.PD_PredictorGetInputNames.restype = ctypes.c_int
    lib.PD_PredictorGetInputNames.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int]
    lib.PD_PredictorSetInput.restype = ctypes.c_int
    lib.PD_PredictorSetInput.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_char_p]
    lib.PD_PredictorRun.restype = ctypes.c_int
    lib.PD_PredictorRun.argtypes = [ctypes.c_int64]
    lib.PD_PredictorGetOutputDims.restype = ctypes.c_int
    lib.PD_PredictorGetOutputDims.argtypes = [
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int]
    lib.PD_PredictorGetOutputDtype.restype = ctypes.c_int
    lib.PD_PredictorGetOutputDtype.argtypes = [
        ctypes.c_int64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.PD_PredictorCopyOutput.restype = ctypes.c_int64
    lib.PD_PredictorCopyOutput.argtypes = [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    assert lib.PD_Init(b"") == 0, lib.PD_GetLastError().decode()
    return lib


def _capi_run(lib, prefix, name, x, out_shape, device=b"cpu"):
    h = lib.PD_PredictorCreate(prefix.encode(), device)
    assert h > 0, lib.PD_GetLastError().decode()
    bufs = [ctypes.create_string_buffer(64) for _ in range(4)]
    arr = (ctypes.c_char_p * 4)(*[ctypes.cast(b, ctypes.c_char_p)
                                  for b in bufs])
    assert lib.PD_PredictorGetInputNames(h, arr, 4, 64) == 1
    assert bufs[0].value == name.encode()
    xc = np.ascontiguousarray(x)
    dims = (ctypes.c_int64 * xc.ndim)(*xc.shape)
    assert lib.PD_PredictorSetInput(
        h, name.encode(), xc.ctypes.data_as(ctypes.c_void_p), dims, xc.ndim,
        str(xc.dtype).encode()) == 0, lib.PD_GetLastError().decode()
    assert lib.PD_PredictorRun(h) == 1, lib.PD_GetLastError().decode()
    odims = (ctypes.c_int64 * 8)()
    nd = lib.PD_PredictorGetOutputDims(h, 0, odims, 8)
    assert list(odims[:nd]) == list(out_shape)
    dt = ctypes.create_string_buffer(16)
    assert lib.PD_PredictorGetOutputDtype(h, 0, dt, 16) == 0
    assert dt.value == b"float32"
    out = np.empty(out_shape, np.float32)
    wrote = lib.PD_PredictorCopyOutput(h, 0, out.ctypes.data_as(
        ctypes.c_void_p), out.nbytes)
    assert wrote == out.nbytes, lib.PD_GetLastError().decode()
    lib.PD_PredictorDestroy(h)
    return out


def test_c_api_end_to_end(saved):
    out, x = saved
    lib = _capi()
    prefix, expect = out[paddle]
    got = _capi_run(lib, prefix, "feats", x, (4, 3))
    assert got.tobytes() == expect.tobytes()
    np.testing.assert_allclose(got, out[pt][1], rtol=RTOL, atol=ATOL)
    assert lib.PD_PredictorCreate(b"/nonexistent/model", b"cpu") == 0
    assert lib.PD_GetLastError() != b""


def test_gpt_through_predictor_c_api_and_bf16_storage(tmp_path):
    """The 2-layer narrow GPT saved with a dynamic batch, then served."""
    from paddle_tpu_torch.inference import PrecisionType
    from paddle_tpu_torch.inference import convert_to_mixed_precision

    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny(hidden_size=64, num_heads=2))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(hidden_size=64, num_heads=2),
                        device="cpu", seed=1)
    load_reference_state_dict(tm, {k: np.asarray(v.numpy())
                                   for k, v in jm.state_dict().items()})
    tm.eval()
    prefix = str(tmp_path / "gpt")
    paddle.jit.save(tm, prefix, input_spec=[
        paddle.jit.InputSpec([None, 16], "int64", name="input_ids")])
    ids = np.random.default_rng(5).integers(0, 512, (3, 16))
    with torch.no_grad():
        eager = tm(torch.from_numpy(ids)).numpy()
    jax_logits = np.asarray(jm(pt.to_tensor(ids)).numpy())
    pred = paddle.inference.create_predictor(_cfg(paddle, prefix))
    (got,) = pred.run([ids])
    assert got.tobytes() == eager.tobytes()
    np.testing.assert_allclose(got, jax_logits, rtol=1e-5, atol=1e-5)
    capi = _capi_run(_capi(), prefix, "input_ids", ids, eager.shape)
    assert capi.tobytes() == eager.tobytes()
    # bf16 storage: the loader casts back to the program's f32
    mixed = str(tmp_path / "mixed")
    convert_to_mixed_precision(prefix + ".pdmodel", prefix + ".pdiparams",
                               mixed + ".pdmodel", mixed + ".pdiparams",
                               PrecisionType.Bfloat16)
    from paddle_tpu_torch.jit.save_load import load_params

    stored = load_params(mixed + ".pdiparams")
    assert {v.dtype for v in stored.values()} == {torch.bfloat16}
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(p.to(torch.bfloat16).float())
        rounded = tm(torch.from_numpy(ids)).numpy()
    (got16,) = paddle.inference.create_predictor(_cfg(paddle, mixed)).run(
        [ids])
    assert got16.tobytes() == rounded.tobytes()
    with pytest.raises(ValueError):
        convert_to_mixed_precision(prefix + ".pdmodel", prefix + ".pdiparams",
                                   mixed + ".pdmodel", mixed + ".pdiparams",
                                   PrecisionType.Bfloat16,
                                   keep_io_types=False)


def test_enums_queries_and_pool(saved):
    out, x = saved
    J, T = pt.inference, paddle.inference
    assert set(J.__all__) == set(T.__all__)
    for name in ("DataType", "PlaceType", "PrecisionType"):
        assert [(m.name, m.value) for m in getattr(T, name)] == \
            [(m.name, m.value) for m in getattr(J, name)]
    for dt in J.DataType:
        assert T.get_num_bytes_of_data_type(T.DataType[dt.name]) == \
            J.get_num_bytes_of_data_type(dt)
    assert T.get_trt_compile_version() == J.get_trt_compile_version()
    assert T.get_trt_runtime_version() == (0, 0, 0)
    for op in ("matmul_v2", "elementwise_add", "reduce_sum", "relu"):
        assert T._get_phi_kernel_name(op) == J._get_phi_kernel_name(op)
    assert T.get_version().endswith(paddle.version.full_version)
    assert T.Tensor is T.InferTensor
    pool = T.PredictorPool(_cfg(paddle, out[paddle][0]), size=2)
    a, b = pool.retrieve(0), pool.retrieve(1)
    assert a is not b
    np.testing.assert_array_equal(a.run([x])[0], b.run([x])[0])
