"""The rest of ``paddle.static`` (``paddle_tpu/static/legacy.py``):
``append_backward``/``gradients`` (``fluid/backward.py``), scopes,
``CompiledProgram``/``BuildStrategy``/``ExecutionStrategy`` (program
wrappers whose graph passes the capture makes moot), ``Print`` and
``py_func``, ``WeightNormParamAttr``, ``ExponentialMovingAverage``, the
serialization and ``save``/``load`` of programs, and the small helpers.
The IPU entries are absent, as in the JAX package.
"""
from __future__ import annotations

import pickle
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

__all__ = [
    "append_backward", "gradients", "scope_guard", "name_scope",
    "BuildStrategy", "ExecutionStrategy", "CompiledProgram", "Print",
    "py_func", "WeightNormParamAttr", "ExponentialMovingAverage",
    "save", "load", "save_to_file", "load_from_file",
    "serialize_program", "serialize_persistables", "deserialize_program",
    "deserialize_persistables", "set_program_state", "normalize_program",
    "Variable", "create_global_var", "create_parameter", "device_guard",
    "load_program_state", "accuracy", "auc", "exponential_decay",
    "ctr_metric_bundle",
]


# ------------------------------------------------------------- autograd
def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """``fluid/backward.py`` append_backward: runs the backward of
    ``loss`` (its graph kept) and returns ``[(param, grad)]``."""
    loss.backward(retain_graph=True)
    params = parameter_list
    if params is None:
        from . import _collect_parameters

        params = _collect_parameters(loss)
    return [(p, p.grad) for p in params if p.grad is not None]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``static/gradients``: ``paddle.grad`` of ``targets`` with respect
    to ``inputs`` (None for an input they do not reach)."""
    from ..autograd import grad

    return grad(targets, inputs, grad_outputs=target_gradients,
                allow_unused=True)


# ------------------------------------------------------------- scoping
class _Scope:
    def __init__(self):
        self.vars = {}

    def var(self, name):
        return self.vars.setdefault(name, None)

    def find_var(self, name):
        return self.vars.get(name)


_scope_stack = [_Scope()]


@contextmanager
def scope_guard(scope):
    """``static/scope_guard``: a variable scope for the block."""
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


_name_scope_stack = []


@contextmanager
def name_scope(prefix: str = None):
    """``static/name_scope``: op-name prefixes for debugging."""
    _name_scope_stack.append(prefix or "")
    try:
        yield
    finally:
        _name_scope_stack.pop()


# ----------------------------------------------------- program wrappers
class BuildStrategy:
    """The graph-build options (the reference's SSA graph passes). The
    capture holds the whole step; the knobs are kept so that reference
    configurations parse."""

    def __init__(self):
        self.enable_inplace = True
        self.memory_optimize = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.build_cuda_graph = False


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


class CompiledProgram:
    """``CompiledProgram``: a Program and its build strategy; it runs
    through ``Executor`` as the Program does."""

    def __init__(self, program,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()

    def __getattr__(self, item):
        if item == "_program":  # absent while unpickling: no recursion
            raise AttributeError(item)
        return getattr(self._program, item)


# ------------------------------------------------------------ debug ops
def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """The Print op: prints the tensor's shape, dtype and first values and
    returns it. Under a CUDA-graph capture the values are not on the host:
    it prints the shape and dtype once, at the capture."""
    from ..ops._apply import ensure_tensor

    t = ensure_tensor(input)
    v = t._value
    head = message or "Print"
    print(f"{head}: shape={list(v.shape)} dtype={v.dtype}")
    if not (v.is_cuda and torch.cuda.is_current_stream_capturing()):
        flat = t.numpy().reshape(-1)
        if summarize >= 0:
            flat = flat[:summarize]
        print(f"  data: {flat}")
    return t


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """The py_func op: ``func`` on the inputs as Tensors, one op of the
    program. ``out`` declares the outputs (the JAX package's
    ``pure_callback`` spec); ``func`` runs on the host, so it cannot run
    inside a CUDA-graph capture."""
    from ..autograd.engine import apply_op
    from ..ops._apply import ensure_tensor
    from ..tensor import Tensor

    xs = [ensure_tensor(t) for t in (x if isinstance(x, (list, tuple))
                                     else [x])]

    def fn(*vals):
        res = func(*[Tensor._wrap(v) for v in vals])
        if isinstance(res, (list, tuple)):
            return [torch.as_tensor(o._value if isinstance(o, Tensor)
                                    else np.asarray(o)) for o in res]
        return res._value if isinstance(res, Tensor) else torch.as_tensor(
            np.asarray(res))

    return apply_op(fn, xs, name="py_func")


# ------------------------------------------------------------- training
class WeightNormParamAttr:
    """``static/WeightNormParamAttr``: a ParamAttr asking for weight
    normalization (``nn.utils.weight_norm``)."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable


class ExponentialMovingAverage:
    """``static/ExponentialMovingAverage``: ``update()`` after each step;
    ``apply()`` swaps the averages in (in place) for evaluation;
    ``restore()`` puts the weights back."""

    def __init__(self, decay: float = 0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._ema: dict = {}
        self._backup: dict = {}
        self._params: list = []
        self._step = 0

    def _track(self, params):
        for p in params:
            if id(p) not in self._ema:
                self._params.append(p)
                self._ema[id(p)] = p._value.detach().clone()

    @torch.no_grad()
    def update(self, parameters=None):
        if parameters is not None:
            self._track(parameters)
        self._step += 1
        # the reference's _get_ema_decay: the (1+t)/(10+t) ramp applies
        # only with thres_steps
        if self._thres_steps is not None:
            d = min(self._decay, (1 + self._step) / (10 + self._step))
        else:
            d = self._decay
        for p in self._params:
            self._ema[id(p)] = d * self._ema[id(p)] + (1.0 - d) * p._value

    @contextmanager
    def apply(self, executor=None, need_restore=True):
        with torch.no_grad():
            for p in self._params:
                self._backup[id(p)] = p._value.detach().clone()
                p._value.copy_(self._ema[id(p)])
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p._value.copy_(self._backup.pop(id(p)))


# ------------------------------------------------- program serialization
class Variable:
    """A named value descriptor (the reference's framework Variable; the
    placeholders of ``static.data`` play its part)."""

    def __init__(self, name, shape=None, dtype=None):
        self.name = name
        self.shape = shape
        self.dtype = dtype


def serialize_program(feed_vars, fetch_vars, **kwargs) -> bytes:
    """``static/io.py`` serialize_program: the feed interface the passed
    variables declare, as bytes."""
    feeds = feed_vars if isinstance(feed_vars, (list, tuple)) else [feed_vars]
    spec = {getattr(v, "name", f"x{i}"): {
                "shape": list(getattr(v, "shape", [])),
                "dtype": str(getattr(v, "dtype", "float32"))}
            for i, v in enumerate(feeds)}
    return pickle.dumps({"program": spec})


def serialize_persistables(feed_vars, fetch_vars, **kwargs) -> bytes:
    """The parameters the fetches reach, as numpy arrays by name."""
    from . import _collect_parameters_multi

    fetches = (fetch_vars if isinstance(fetch_vars, (list, tuple))
               else [fetch_vars])
    params = _collect_parameters_multi(fetches, trainable_only=False)
    return pickle.dumps({
        (getattr(p, "name", None) or f"param_{i}"): p.numpy()
        for i, p in enumerate(params)})


def deserialize_program(data: bytes):
    return pickle.loads(data)["program"]


def deserialize_persistables(program, data: bytes, executor=None):
    return pickle.loads(data)


def save_to_file(path: str, content: bytes) -> None:
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def save(program, model_prefix: str, protocol: int = 4) -> None:
    """``static/save``: the program's parameters to
    ``<prefix>.pdparams``."""
    state = program._param_state() if hasattr(program, "_param_state") else {}
    with open(model_prefix + ".pdparams", "wb") as f:
        pickle.dump(state, f, protocol=protocol)


def load(program, model_prefix: str, executor=None, var_list=None) -> None:
    with open(model_prefix + ".pdparams", "rb") as f:
        state = pickle.load(f)
    if hasattr(program, "_set_param_state"):
        program._set_param_state(state)


def set_program_state(program, state_dict) -> None:
    if hasattr(program, "_set_param_state"):
        program._set_param_state(state_dict)


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """``static/normalize_program``: the record is already the feed ->
    fetch subgraph a run replays."""
    return program


# ------------------------------------------------------------ var helpers
def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """``static/create_global_var``: a filled tensor on the default
    device (the CPU with ``force_cpu``)."""
    from ..device import default_device
    from ..dtypes import convert_dtype
    from ..tensor import Tensor

    dev = torch.device("cpu") if force_cpu else default_device()
    t = Tensor(torch.full(tuple(int(s) for s in shape), value,
                          dtype=convert_dtype(dtype), device=dev),
               stop_gradient=False)
    if name:
        t.name = name
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..framework.core_api import create_parameter as _cp

    return _cp(shape, dtype, name=name, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


@contextmanager
def device_guard(device=None):
    """``static/device_guard``: ``"cpu"`` makes the block's new tensors
    on the CPU; anything else keeps the default device."""
    if device and str(device).startswith("cpu"):
        from ..device import using_device

        with using_device("cpu"):
            yield
    else:
        yield


def load_program_state(model_path, var_list=None):
    """``static/load_program_state``: a saved parameter state."""
    with open(model_path + ".pdparams", "rb") as f:
        return pickle.load(f)


def accuracy(input, label, k=1, correct=None, total=None):
    from ..metric import accuracy as _acc

    return _acc(input, label, k=k)


def _host(x) -> np.ndarray:
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """``static/auc``: the AUC of this batch's predictions (``metric.Auc``
    keeps a running one), as a float64 Tensor."""
    from ..metric import Auc
    from ..tensor import Tensor

    m = Auc(curve=curve, num_thresholds=num_thresholds)
    m.update(_host(input), _host(label))
    return Tensor(np.asarray(m.accumulate(), np.float64))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """``fluid/layers`` exponential_decay: an LR scheduler."""
    from ..optimizer.lr import ExponentialDecay

    del decay_steps, staircase  # per-epoch semantics in the LR API
    return ExponentialDecay(learning_rate=learning_rate, gamma=decay_rate)


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """``static/ctr_metric_bundle``: (auc, sqrerr, abserr, prob, q, pos,
    total) of a CTR batch."""
    from ..tensor import Tensor

    pred = _host(input).reshape(-1)
    lab = _host(label).reshape(-1)
    sqrerr = float(((pred - lab) ** 2).sum())
    abserr = float(np.abs(pred - lab).sum())
    q = float(pred.sum())
    pos = float(lab.sum())
    total = float(lab.size)
    auc_v = float(auc(Tensor(pred), Tensor(lab.astype("int64"))).numpy())

    def mk(v):
        return Tensor(np.asarray(v))

    return (mk(auc_v), mk(sqrerr), mk(abserr), mk(q / max(total, 1)),
            mk(q), mk(pos), mk(total))
