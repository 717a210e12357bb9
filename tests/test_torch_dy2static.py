"""paddle_tpu_torch.jit.dy2static against the JAX package's: twins of
``tests/test_dy2static.py``, the AST pass's parity, and a greedy decode
under ``to_static`` in both packages.

The converted functions below read the package they run on from the
module global ``P`` (and ``_W``, ``t``): :func:`_use` points them at one
package, and each package's ``ast_transform`` execs its rewrite against
these live globals, as the JAX package's tests rely on. A scenario
returns what it computed; the JAX package's results are computed once
(a module-scoped fixture) and each twin holds the port's equal: f32
values within 1e-6 (the JAX tests' tolerance), integers, dtypes, program
counts and error types exactly.

On the CPU the port's ``StaticFunction`` runs every call eagerly, so
where the JAX package's traced regime refuses a traced range step, the
twin holds that the JAX package raises and that the port, in its
concrete regime, computes the eager answer; the card's captured regime
raises as the JAX trace does (``chip_smoke.py`` phase 27 holds the
captured regime). ``jit.save`` of
a forward with converted control flow is not ported yet: its twin holds
the ``to_static`` part and the port's refusal.
"""
import ast
import copy
import inspect
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import jit as jjit
from paddle_tpu.jit import dy2static as jdy
from paddle_tpu_torch import jit
from paddle_tpu_torch.jit import dy2static as tdy
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

P = None     # the package the converted functions run on (``_use``)
t = None
_W = None


def _use(pkg):
    """Point the converted functions at ``pkg``; returns its jit and
    dy2static modules."""
    global P, t, _W
    pkg.seed(0)  # a trace that raised may leave a tracer in the key slot
    P, t = pkg, pkg.to_tensor
    _W = t(np.float32(3.0))
    return (jjit, jdy) if pkg is pt else (jit, tdy)


def _f(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x).item()


def _i(x):
    return int(np.asarray(x.numpy() if hasattr(x, "numpy") else x))


def _arr(v):
    return t(np.asarray(v, np.float32))


# ------------------------------------------------ converted functions
def _tensor_if(x):
    if x.sum() > 0:
        y = x * _W
    else:
        y = x - _W
    return y.sum()


def _tensor_while(x, n):
    i = P.to_tensor(np.int64(0))
    s = x
    while i < n:
        s = s * 1.5
        i = i + 1
    return s


def _early_return(x):
    if x.sum() > 0:
        return x * 10.0
    else:
        return x * 100.0


def _plain_python(x, n):
    total = 0
    i = 0
    while i < n:
        total = total + i
        i += 1
    if n > 2:
        total = total * 10
    return total + x


def _logical(x, flag):
    if flag and (x.sum() > 0):
        return x * 2.0
    else:
        return x * 3.0


def _with_break(x, n):
    out = x
    for _ in range(10):
        out = out + 1.0
        if n < 3:
            break
    return out


def _late_bound(x):
    if x.sum() > 0:
        y = _helper_defined_later(x)
    else:
        y = x
    return y


def _helper_defined_later(x):
    return x * 7.0


def _tensor_for_range(x, n):
    s = x
    for i in range(n):
        s = s + i
    return s


def _concrete_for_range(x):
    s = x
    for i in range(3):
        s = s * 2.0
    return s


def _for_range_start_step(x, n):
    s = x
    for i in range(2, n, 3):
        s = s + i
    return s


def _for_read_target_after(x, n):
    s = x
    for i in range(n):
        s = s + 1.0
    return s + i  # noqa: F821  (target read after the loop)


def _for_int32_accumulator(x, n):
    s = P.to_tensor(np.int32(0))
    for i in range(n):
        s = s + i
    return s


def _for_traced_step(x, st):
    s = x
    for i in range(0, 6, st):
        s = s + 1.0
    return s


def _shadowed_range(x):
    range = lambda n: [10, 20]  # noqa: E731, A001
    s = x
    for i in range(None):
        s = s + i
    return s


def _float_range(x):
    s = x
    for i in range(2.5):  # CPython: TypeError
        s = s + 1.0
    return s


def _for_tensor_start_and_stop(x, a, n):
    s = P.to_tensor(np.int32(0))
    for i in range(a, n):
        s = s + i
    return s


def _float_tensor_range(x, n):
    s = x
    for i in range(n):  # n is a float TENSOR: must raise like CPython
        s = s + 1.0
    return s


def _while_break(x, limit):
    s = x
    i = P.to_tensor(np.int64(0))
    while i < limit:
        s = s + x
        i = i + 1
        if s.sum() > 10.0:
            break
    return s


def _for_break(x, n):
    s = x
    for i in range(n):
        s = s + 1.0
        if s.sum() > 5.0:
            break
    return s


def _for_continue(x, n):
    s = x
    for i in range(n):
        if i % 2 == 0:
            continue
        s = s + i
    return s


def _while_continue(x, n):
    s = x
    i = P.to_tensor(np.int64(0))
    while i < n:
        i = i + 1
        if i % 2 == 0:
            continue
        s = s + 1.0
    return s


def _nested_break(x, n):
    s = x
    for i in range(n):
        for j in range(3):
            s = s + 1.0
            if j >= 1:
                break  # binds the INNER loop only
    return s


def _stmt_after_break_if(x, n):
    s = x
    for i in range(n):
        if s.sum() > 2.0:
            break
        s = s + 1.0   # must be skipped once the flag is up
        s = s * 1.0
    return s


def _loop_return(n):
    acc = 0
    for i in range(n):
        acc = acc + i
        if acc > 5:
            return acc * 10
    return acc


def _partial_return(x):
    if x.sum() > 0:
        return x * 10.0
    y = x + 1.0
    return y * 2.0


def _nested_partial_return(x):
    if x.sum() > 0:
        if x.sum() > 10:
            return x * 100.0
        x = x + 1.0
    return x * 2.0


def _ret_none(flag):
    if flag:
        return 5


def _return_in_compiled_loop(x, n):
    s = x
    for i in range(n):
        s = s + 1.0
        if s.sum() > 3.0:
            return s * 5.0
    return s


def _target_after_break(x, n):
    i = -1
    for i in range(n):
        x = x + 1.0
        if x.sum() > 3.0:
            break
    return i


def _while_index_break(arr):
    i = 0
    while arr[i] > 0:
        i = i + 1
        if i >= len(arr):
            break
    return i


def _outer_break_inner_plain_loop(x, n):
    for i in range(n):
        x = x + 1.0
        if x.sum() > 3.0:
            break
        for item in [1, 2]:     # non-range loop: stays plain Python
            if item > 1:
                break
            x = x + item
    return x


def _iter_tensor_rows(m):
    s = P.to_tensor(np.float32(0.0))
    for row in m:                  # Tensor: iterate axis 0
        s = s + row.sum()
    return s


def _iter_plain_things(xs, d):
    s = 0.0
    for k in d:                    # dict: keys, exact python
        s = s + d[k]
    for v in xs:                   # list
        s = s + v
    for g in (i * 2 for i in range(3)):   # generator
        s = s + g
    return s


def _iter_params_like(ws, x):
    out = x
    for w in ws:                   # list of tensors (parameters pattern)
        out = out * w
    return out


def _iter_scalar(s0):
    acc = P.to_tensor(np.float32(0.0))
    for v in s0:               # 0-d tensor: must raise like paddle
        acc = acc + v
    return acc


def _break_and_continue(x, n):
    s = x
    i = P.to_tensor(np.int64(0))
    while i < n:
        i = i + 1
        if i % 2 == 0:
            continue
        if s.sum() > 4.0:
            break
        s = s + 1.0
    return s, i


def _two_breaks_two_depths(x, n):
    s = x
    i = P.to_tensor(np.int64(0))
    while i < n:
        i = i + 1
        if s.sum() > 50.0:
            break
        s = s + 1.0
        if i > 5:
            if s.sum() > 3.0:
                break
    return s


def _sequential_break_loops(x, n):
    s = x
    for i in range(n):
        s = s + 1.0
        if s.sum() > 2.0:
            break
    for j in range(n):
        s = s + 10.0
        if s.sum() > 25.0:
            break
    return s


def _nested_while_breaks(x, n):
    s = x
    i = P.to_tensor(np.int64(0))
    while i < n:
        i = i + 1
        j = P.to_tensor(np.int64(0))
        while j < n:
            j = j + 1
            s = s + 1.0
            if s.sum() % 3.0 < 0.5:
                break   # inner only
        if s.sum() > 8.0:
            break
    return s, i


def _return_in_else(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        return x * -1.0
    return y + 1.0


def _decode(model, tokens, cur, stop):
    B, L = tokens.shape[0], tokens.shape[1]
    done = P.zeros([B], dtype="bool")
    pos = P.arange(L, dtype="int64")
    while cur < L and not P.all(done):
        logits = model(tokens)
        last = P.index_select(logits, (cur - 1).reshape([1]), axis=1)
        nxt = P.argmax(last, axis=-1)
        tokens = P.where(pos == cur, nxt, tokens)
        done = P.logical_or(done, nxt.reshape([B]) == stop)
        cur = cur + 1
    return tokens, cur


def _gated_forward(self, x):
    if x.sum() > 0:
        y = self.a(x)
    else:
        y = self.b(x)
    return y


# ------------------------------------------------------------ scenarios
def _raises(fn):
    try:
        return ("value", fn())
    except Exception as e:  # the scenario records which error
        return ("raised", type(e).__name__, str(e)[:80])


def _sf(dy, jit_, fn):
    return jit_.StaticFunction(dy.ast_transform(fn), warmup=False)


def sc_transform(jit_, dy):
    g = dy.ast_transform(_plain_python)
    return (hasattr(g, "__dy2static_original__"),
            _f(g(t(np.float32(1.0)), 4)),
            _f(_plain_python(t(np.float32(1.0)), 4)))


def sc_if_grad(jit_, dy):
    w = _W
    w.stop_gradient = False
    out = dy.ast_transform(_tensor_if)(_arr([1.0, 2.0]))
    out.backward()
    return _f(out), _f(w.grad)


def sc_if_both(jit_, dy):
    sf = _sf(dy, jit_, _tensor_if)
    return (_f(sf(_arr([1.0, 2.0]))), _f(sf(_arr([-1.0, -2.0]))),
            len(sf._cache))


def sc_while_trips(jit_, dy):
    sf = _sf(dy, jit_, _tensor_while)
    return (_f(sf(_arr([1.0]), t(np.int64(3)))),
            _f(sf(_arr([1.0]), t(np.int64(6)))), len(sf._cache))


def sc_early_return(jit_, dy):
    sf = _sf(dy, jit_, _early_return)
    return _f(sf(_arr([-1.0]))), _f(sf(_arr([2.0]))), len(sf._cache)


def sc_logical(jit_, dy):
    g = dy.ast_transform(_logical)
    return _f(g(_arr([1.0]), True)), _f(g(_arr([1.0]), False))


def sc_break_python(jit_, dy):
    g = dy.ast_transform(_with_break)
    return _f(g(_arr([0.0]), 1)), _f(g(_arr([0.0]), 5))


def sc_late_bound(jit_, dy):
    g = dy.ast_transform(_late_bound)
    first = _f(g(_arr([2.0])))
    mod = sys.modules[__name__]
    orig = mod._helper_defined_later
    try:
        mod._helper_defined_later = lambda x: x * 100.0
        second = _f(g(_arr([2.0])))
    finally:
        mod._helper_defined_later = orig
    return first, second


def sc_gated_layer(jit_, dy):
    class Gated(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = P.nn.Linear(4, 4)
            self.b = P.nn.Linear(4, 4)

        forward = _gated_forward

    m = Gated()
    rng = np.random.default_rng(0)
    for lin in (m.a, m.b):
        for p in (lin.weight, lin.bias):
            arr = rng.standard_normal(tuple(p.shape)).astype("f4") * 0.3
            if P is pt:
                import jax.numpy as jnp

                p._set_value(jnp.asarray(arr))
            else:
                with torch.no_grad():
                    p._value.copy_(torch.as_tensor(arr))
    sf = jit_.to_static(m.forward, warmup=False)
    pos = np.asarray(sf(t(np.ones((2, 4), np.float32))).numpy())
    neg = np.asarray(sf(t(-np.ones((2, 4), np.float32))).numpy())
    return m, pos, neg, len(sf._cache)


def sc_for_range(jit_, dy):
    f = jit_.to_static(_tensor_for_range)
    return [_f(f(t(np.float32(1.0)), t(np.int64(n)))) for n in (0, 1, 5)]


def sc_for_concrete(jit_, dy):
    return _f(jit_.to_static(_concrete_for_range)(t(np.float32(2.0))))


def sc_for_start_step(jit_, dy):
    f = jit_.to_static(_for_range_start_step)
    return [_f(f(t(np.float32(0.0)), t(np.int64(n)))) for n in (2, 3, 9, 10)]


def sc_target_after(jit_, dy):
    f = jit_.to_static(_for_read_target_after)
    return [_f(f(t(np.float32(0.0)), t(np.int64(4)))) for _ in range(2)]


def sc_int32_acc(jit_, dy):
    f = jit_.to_static(_for_int32_accumulator)
    outs = [f(t(np.float32(0.0)), t(np.int64(5))) for _ in range(2)]
    return [(str(o.dtype).endswith("int32"), _i(o)) for o in outs]


def sc_traced_step(jit_, dy):
    f = jit_.to_static(_for_traced_step)
    return _raises(lambda: [_f(f(t(np.float32(0.0)), t(np.int64(2))))
                            for _ in range(2)])


def sc_shadowed(jit_, dy):
    return _f(jit_.to_static(_shadowed_range)(t(np.float32(0.0))))


def sc_float_range(jit_, dy):
    return _raises(lambda: jit_.to_static(_float_range)(t(np.float32(0.0))))


def sc_start_int32(jit_, dy):
    f = jit_.to_static(_for_tensor_start_and_stop)
    outs = [f(t(np.float32(0.0)), t(np.int64(2)), t(np.int64(6)))
            for _ in range(2)]
    return [(str(o.dtype).endswith("int32"), _i(o)) for o in outs]


def sc_float_tensor_range(jit_, dy):
    f = jit_.to_static(_float_tensor_range)
    return _raises(lambda: f(t(np.float32(0.0)), t(np.float32(2.5))))


def sc_while_break(jit_, dy):
    ref = [_f(_while_break(_arr([1.0]), t(np.int64(lim))))
           for lim in (100, 3)]
    sf = _sf(dy, jit_, _while_break)
    got = [_f(sf(_arr([1.0]), t(np.int64(lim)))) for lim in (100, 3)]
    return ref, got, len(sf._cache)


def sc_for_break(jit_, dy):
    sf = _sf(dy, jit_, _for_break)
    return ([_f(sf(_arr([0.0]), t(np.int64(n)))) for n in (100, 2)],
            len(sf._cache))


def sc_for_break_concrete(jit_, dy):
    return _f(dy.ast_transform(_for_break)(_arr([0.0]), 100))


def sc_traced_break(jit_, dy):
    return _f(_sf(dy, jit_, _for_break)(_arr([0.0]), 20))


def sc_for_continue(jit_, dy):
    eager = _f(dy.ast_transform(_for_continue)(_arr([0.0]), 7))
    comp = _f(_sf(dy, jit_, _for_continue)(_arr([0.0]), t(np.int64(7))))
    return eager, comp


def sc_while_continue(jit_, dy):
    return _f(_sf(dy, jit_, _while_continue)(_arr([0.0]), t(np.int64(6))))


def sc_nested_break(jit_, dy):
    return (_f(dy.ast_transform(_nested_break)(_arr([0.0]), 4)),
            _f(_sf(dy, jit_, _nested_break)(_arr([0.0]), t(np.int64(4)))))


def sc_after_break(jit_, dy):
    return _f(_sf(dy, jit_, _stmt_after_break_if)(_arr([0.0]),
                                                  t(np.int64(50))))


def sc_loop_return(jit_, dy):
    g = dy.ast_transform(_loop_return)
    return int(g(2)), int(g(5)), int(_loop_return(2)), int(_loop_return(5))


def sc_partial_return(jit_, dy):
    sf = _sf(dy, jit_, _partial_return)
    return _f(sf(_arr([2.0]))), _f(sf(_arr([-1.0]))), len(sf._cache)


def sc_nested_partial(jit_, dy):
    sf = _sf(dy, jit_, _nested_partial_return)
    return [_f(sf(_arr(v))) for v in ([20.0], [2.0], [-3.0])], \
        len(sf._cache)


def sc_ret_none(jit_, dy):
    g = dy.ast_transform(_ret_none)
    return g(True), g(False)


def sc_return_in_loop(jit_, dy):
    eager = _f(dy.ast_transform(_return_in_compiled_loop)(_arr([0.0]), 10))
    sf = _sf(dy, jit_, _return_in_compiled_loop)
    return eager, _raises(lambda: _f(sf(_arr([0.0]), t(np.int64(10)))))


def sc_target_frozen(jit_, dy):
    g = dy.ast_transform(_target_after_break)
    sf = _sf(dy, jit_, _target_after_break)
    return (_i(_target_after_break(_arr([0.0]), 20)),
            _i(g(_arr([0.0]), 20)), _i(sf(_arr([0.0]), 20)),
            _i(sf(_arr([0.0]), t(np.int64(20)))))


def sc_while_index(jit_, dy):
    arr = [1.0, 2.0, 3.0]
    return _while_index_break(arr), _i(dy.ast_transform(_while_index_break)(
        arr))


def sc_outer_break(jit_, dy):
    return (_f(dy.ast_transform(_outer_break_inner_plain_loop)(_arr([0.0]),
                                                               10)),
            _f(_outer_break_inner_plain_loop(_arr([0.0]), 10)))


def sc_iter_rows(jit_, dy):
    m = t(np.arange(6, dtype=np.float32).reshape(3, 2))
    return (_f(dy.ast_transform(_iter_tensor_rows)(m)),
            _f(_sf(dy, jit_, _iter_tensor_rows)(m)))


def sc_iter_plain(jit_, dy):
    d = {"a": 10.0, "b": 20.0}
    return (dy.ast_transform(_iter_plain_things)([1.0, 2.0], d),
            _iter_plain_things([1.0, 2.0], d))


def sc_iter_list(jit_, dy):
    ws = [t(np.float32(2.0)), t(np.float32(3.0))]
    return _f(dy.ast_transform(_iter_params_like)(ws, t(np.float32(1.0))))


def sc_iter_0d(jit_, dy):
    return _raises(lambda: dy.ast_transform(_iter_scalar)(t(np.float32(3.0))))


def sc_break_continue(jit_, dy):
    want = _break_and_continue(_arr([0.0]), t(np.int64(100)))
    s, i = _sf(dy, jit_, _break_and_continue)(_arr([0.0]), t(np.int64(100)))
    return (_f(want[0]), _i(want[1])), (_f(s), _i(i))


def sc_two_depths(jit_, dy):
    want = _f(_two_breaks_two_depths(_arr([0.0]), t(np.int64(100))))
    return want, _f(_sf(dy, jit_, _two_breaks_two_depths)(_arr([0.0]),
                                                          t(np.int64(100))))


def sc_sequential(jit_, dy):
    want = _f(_sequential_break_loops(_arr([0.0]), 100))
    return want, _f(_sf(dy, jit_, _sequential_break_loops)(
        _arr([0.0]), t(np.int64(100))))


def sc_nested_while(jit_, dy):
    a = _nested_while_breaks(_arr([0.0]), t(np.int64(50)))
    s, i = _sf(dy, jit_, _nested_while_breaks)(_arr([0.0]), t(np.int64(50)))
    return (_f(a[0]), _i(a[1])), (_f(s), _i(i))


def sc_return_else(jit_, dy):
    sf = _sf(dy, jit_, _return_in_else)
    return _f(sf(_arr([3.0]))), _f(sf(_arr([-3.0]))), len(sf._cache)


SCENARIOS = {n[3:]: f for n, f in dict(globals()).items()
             if n.startswith("sc_") and callable(f)}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's result of every scenario, computed once."""
    out = {}
    for name, fn in SCENARIOS.items():
        jit_, dy = _use(pt)
        out[name] = fn(jit_, dy)
    return out


def _port(name):
    jit_, dy = _use(paddle)
    return SCENARIOS[name](jit_, dy)


def _twin(jax_ref, name):
    got = _port(name)
    assert _plain(got) == _plain(jax_ref[name]), (got, jax_ref[name])
    return got


def _plain(x):
    """Floats rounded to f32's 1e-6 relative (the JAX tests' rtol)."""
    if isinstance(x, float):
        return float(f"{x:.6g}")
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


# ---------------------------------------------------------------- twins
def test_transform_applies_and_preserves_python_semantics(jax_ref):
    assert _twin(jax_ref, "transform") == (True, 61.0, 61.0)


def test_tensor_if_eager_with_grad(jax_ref):
    assert _twin(jax_ref, "if_grad") == (9.0, 3.0)


def test_tensor_if_compiles_both_branches_one_program(jax_ref):
    assert _twin(jax_ref, "if_both") == (9.0, -9.0, 1)


def test_tensor_while_compiles_data_dependent_trip_count(jax_ref):
    a, b, n = _twin(jax_ref, "while_trips")
    np.testing.assert_allclose([a, b], [1.5 ** 3, 1.5 ** 6], rtol=1e-6)
    assert n == 1


def test_early_return_if_compiles(jax_ref):
    assert _twin(jax_ref, "early_return") == (-100.0, 20.0, 1)


def test_logical_ops_in_test(jax_ref):
    assert _twin(jax_ref, "logical") == (2.0, 3.0)


def test_break_containing_loop_left_as_python(jax_ref):
    assert _twin(jax_ref, "break_python") == (1.0, 10.0)


def test_unavailable_source_falls_back():
    for dy in (jdy, tdy):
        fn = eval("lambda x: x + 1")
        assert dy.ast_transform(fn) is fn


def test_undefined_sentinel_raises_on_bool():
    for dy in (jdy, tdy):
        with pytest.raises(NameError):
            bool(dy.UNDEFINED)


def test_late_bound_globals_and_monkeypatch_work(jax_ref):
    assert _twin(jax_ref, "late_bound") == (14.0, 200.0)


def test_layer_method_with_tensor_branch_compiles_and_saves(jax_ref,
                                                            tmp_path):
    """The ``to_static`` part as the JAX test's; ``jit.save`` of the
    converted forward through both packages (the Layer path: its
    parameters in the ``.pdiparams``), each loaded program taking both
    branches as its ``to_static`` call did."""
    jm, jpos, jneg, jn = jax_ref["gated_layer"]
    m, pos, neg, n = _port("gated_layer")
    np.testing.assert_allclose(pos, jpos, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(neg, jneg, rtol=1e-6, atol=1e-6)
    assert n == jn == 1 and not np.allclose(pos, neg)
    for P, layer in ((paddle, m), (pt, jm)):
        P.jit.save(layer, str(tmp_path / P.__name__),
                   input_spec=[P.jit.InputSpec((2, 4), "float32")])
    tl = jit.load(str(tmp_path / "paddle_tpu_torch"), device="cpu")
    jl = pt.jit.load(str(tmp_path / "paddle_tpu"))
    for x, want in ((np.ones((2, 4), np.float32), pos),
                    (-np.ones((2, 4), np.float32), neg)):
        got = np.asarray(tl(x).numpy())
        assert got.tobytes() == np.asarray(want, np.float32).tobytes()
        np.testing.assert_allclose(got, np.asarray(jl(pt.to_tensor(
            x)).numpy()), rtol=1e-5, atol=1e-6)
    assert os.path.getsize(str(tmp_path / "paddle_tpu_torch.pdiparams")) \
        > 100


def test_for_over_tensor_range_compiles(jax_ref):
    assert _twin(jax_ref, "for_range") == [1.0, 1.0, 11.0]


def test_for_concrete_range_still_unrolls(jax_ref):
    assert _twin(jax_ref, "for_concrete") == 16.0


def test_for_range_start_step(jax_ref):
    assert _twin(jax_ref, "for_start_step") == [
        float(sum(range(2, n, 3))) for n in (2, 3, 9, 10)]


def test_for_target_readable_after_compiled_loop(jax_ref):
    assert _twin(jax_ref, "target_after") == [7.0, 7.0]


def test_for_header_does_not_promote_int32_accumulator(jax_ref):
    assert _twin(jax_ref, "int32_acc") == [(True, 10), (True, 10)]


def test_for_traced_step_raises_clearly(jax_ref):
    """The JAX trace refuses a traced step; the port's concrete regime
    (the CPU) runs the loop with the step's value."""
    assert jax_ref["traced_step"][:2] == ("raised", "NotImplementedError")
    assert "TRACED step" in jax_ref["traced_step"][2]
    assert _port("traced_step") == ("value", [3.0, 3.0])


def test_for_shadowed_range_keeps_python_semantics(jax_ref):
    assert _twin(jax_ref, "shadowed") == 30.0


def test_for_float_bound_raises_like_cpython(jax_ref):
    assert _twin(jax_ref, "float_range")[:2] == ("raised", "TypeError")


def test_for_tensor_start_int32_header(jax_ref):
    assert _twin(jax_ref, "start_int32") == [(True, 14), (True, 14)]


def test_for_float_tensor_bound_raises_like_cpython(jax_ref):
    assert _twin(jax_ref, "float_tensor_range")[:2] == ("raised",
                                                        "TypeError")


def test_while_break_compiles_and_matches_eager(jax_ref):
    ref, got, n = _twin(jax_ref, "while_break")
    assert ref == got == [11.0, 4.0] and n == 1


def test_for_range_tensor_bound_break_compiles(jax_ref):
    assert _twin(jax_ref, "for_break") == ([6.0, 2.0], 1)


def test_for_range_concrete_bound_break_matches_cpython(jax_ref):
    assert _twin(jax_ref, "for_break_concrete") == 6.0


def test_concrete_bound_traced_break_still_correct(jax_ref):
    assert _twin(jax_ref, "traced_break") == 6.0


def test_for_continue_compiles_and_matches_eager(jax_ref):
    assert _twin(jax_ref, "for_continue") == (9.0, 9.0)


def test_while_continue_compiles(jax_ref):
    assert _twin(jax_ref, "while_continue") == 3.0


def test_nested_loops_break_binds_inner(jax_ref):
    assert _twin(jax_ref, "nested_break") == (8.0, 8.0)


def test_statements_after_break_are_guarded(jax_ref):
    assert _twin(jax_ref, "after_break") == 3.0


def test_return_in_loop_eager_exact(jax_ref):
    assert _twin(jax_ref, "loop_return") == (1, 60, 1, 60)


def test_partial_early_return_compiles_one_program(jax_ref):
    assert _twin(jax_ref, "partial_return") == (20.0, 0.0, 1)


def test_nested_partial_return_compiles(jax_ref):
    assert _twin(jax_ref, "nested_partial") == ([2000.0, 6.0, -6.0], 1)


def test_return_none_fallthrough_concrete(jax_ref):
    assert _twin(jax_ref, "ret_none") == (5, None)


def test_return_in_compiled_loop_is_loud_not_silent(jax_ref):
    """The eager regime is exact; with a tensor bound the loop that holds
    a ``return`` stays a Python loop, which refuses the tensor bound in
    both packages rather than returning garbage."""
    eager, compiled = _twin(jax_ref, "return_in_loop")
    assert eager == 20.0 and compiled[:2] == ("raised", "TypeError")


def test_loop_target_frozen_after_break(jax_ref):
    assert _twin(jax_ref, "target_frozen") == (3, 3, 3, 3)


def test_while_test_not_reevaluated_after_break(jax_ref):
    assert _twin(jax_ref, "while_index") == (3, 3)


def test_outer_break_with_nested_plain_loop_stays_plain(jax_ref):
    assert _twin(jax_ref, "outer_break") == (5.0, 5.0)


def test_for_over_tensor_iterates_rows(jax_ref):
    assert _twin(jax_ref, "iter_rows") == (15.0, 15.0)


def test_for_over_plain_iterables_exact(jax_ref):
    assert _twin(jax_ref, "iter_plain") == (39.0, 39.0)


def test_for_over_tensor_list(jax_ref):
    assert _twin(jax_ref, "iter_list") == 6.0


def test_for_over_0d_tensor_raises(jax_ref):
    got = _twin(jax_ref, "iter_0d")
    assert got[:2] == ("raised", "TypeError") and "0-d" in got[2]


def test_break_and_continue_same_loop(jax_ref):
    want, got = _twin(jax_ref, "break_continue")
    assert want == got


def test_breaks_at_two_depths(jax_ref):
    assert _twin(jax_ref, "two_depths") == (6.0, 6.0)


def test_sequential_break_loops_distinct_flags(jax_ref):
    assert _twin(jax_ref, "sequential") == (33.0, 33.0)


def test_nested_while_breaks_bind_correct_loops(jax_ref):
    want, got = _twin(jax_ref, "nested_while")
    assert want == got


def test_return_in_else_branch_compiles(jax_ref):
    assert _twin(jax_ref, "return_else") == (7.0, 3.0, 1)


# ---------------------------------------------------------- AST parity
def _rewrite(dy, fn) -> str:
    """``ast.dump`` of ``dy``'s rewrite of ``fn`` (the passes of its
    ``ast_transform``, without the compile)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    fdef = tree.body[0]
    fdef.decorator_list = []
    n = [0]

    def uid(tag):
        n[0] += 1
        return f"__jst_{tag}_{n[0]}"

    try:
        rr = dy._ReturnRewriter(uid)
        body = rr.transform_block(copy.deepcopy(fdef.body))
        if rr.changed:
            fdef.body = body
    except dy._Bail:
        pass
    tree = dy._BreakContinueRewriter(uid).visit(tree)
    tree = dy._ControlFlowTransformer().visit(tree)
    return ast.dump(ast.fix_missing_locations(tree))


AST_CASES = [
    _tensor_if, _tensor_while, _early_return, _plain_python, _logical,
    _with_break, _late_bound, _tensor_for_range, _concrete_for_range,
    _for_range_start_step, _for_read_target_after, _for_int32_accumulator,
    _for_traced_step, _shadowed_range, _float_range,
    _for_tensor_start_and_stop, _float_tensor_range, _while_break,
    _for_break, _for_continue, _while_continue, _nested_break,
    _stmt_after_break_if, _loop_return, _partial_return,
    _nested_partial_return, _ret_none, _return_in_compiled_loop,
    _target_after_break, _while_index_break, _outer_break_inner_plain_loop,
    _iter_tensor_rows, _iter_plain_things, _iter_params_like, _iter_scalar,
    _break_and_continue, _two_breaks_two_depths, _sequential_break_loops,
    _nested_while_breaks, _return_in_else, _decode, _gated_forward]


@pytest.mark.parametrize("fn", AST_CASES, ids=lambda f: f.__name__)
def test_ast_transform_output_matches_the_jax_package(fn):
    """The port's AST pass is the JAX package's: the same rewrite of each
    test function, node for node (the converters' module is named by the
    same ``__paddle_jst__`` global in both)."""
    assert _rewrite(tdy, fn) == _rewrite(jdy, fn)


# ------------------------------------------------------- greedy decode
def test_greedy_decode_under_to_static_matches_the_jax_package(
        one_torch_thread):
    """The decode of the slice's card path at ``gpt_tiny``'s width: a
    full ``[B, L]`` buffer, ``while cur < L and not all(done)``, under
    ``to_static`` in both packages from the same weights: the same tokens
    and final ``cur``, and both equal to the eager Python loop."""
    from paddle_tpu.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                         load_reference_state_dict)

    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), seed=1, device="cpu").eval()
    load_reference_state_dict(
        tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    rng = np.random.default_rng(4)
    toks = np.zeros((2, 20), np.int64)
    toks[:, :6] = rng.integers(0, 512, (2, 6))
    results = {}
    for pkg, model in ((pt, jm), (paddle, tm)):
        jit_, dy = _use(pkg)
        sf = jit_.to_static(_decode)
        outs = []
        for stop in (-1, int(toks[0, 0])):
            args = (model, t(toks), t(np.int64(6)), t(np.int64(stop)))
            tok, cur = sf(*args)
            etok, ecur = _decode(*args)
            np.testing.assert_array_equal(np.asarray(tok.numpy()),
                                          np.asarray(etok.numpy()))
            assert _i(cur) == _i(ecur)
            outs.append((np.asarray(tok.numpy()), _i(cur)))
        results[pkg.__name__] = outs
    _use(paddle)
    for (jt, jc), (tt, tc) in zip(results["paddle_tpu"],
                                  results["paddle_tpu_torch"]):
        np.testing.assert_array_equal(tt, jt)
        assert tc == jc
    assert results["paddle_tpu_torch"][0][1] == 20


# ------------------------------------------------- the card by default
def test_to_static_tensor_while_defaults_to_the_card(monkeypatch):
    """A ``to_static`` function with a tensor ``while``, given no device,
    makes its tensors on the card: without one it raises, unless told
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _use(paddle)
    prev = paddle.device._current
    paddle.set_device(None)
    try:
        with pytest.raises(RuntimeError):
            jit.to_static(_tensor_while)(
                paddle.to_tensor(np.ones(1, np.float32), place="cpu"),
                paddle.to_tensor(np.int64(2), place="cpu"))
    finally:
        paddle.device._current = prev
    sf = jit.to_static(_tensor_while)
    out = sf(paddle.to_tensor(np.ones(1, np.float32), place="cpu"),
             paddle.to_tensor(np.int64(2), place="cpu"))
    np.testing.assert_allclose(out.numpy(), [2.25])
    assert os.environ.get("PADDLE_TPU_DY2STATIC") != "0"
