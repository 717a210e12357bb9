"""``torch.export`` graph → ONNX ModelProto (``paddle_tpu/onnx/convert.py``).

The JAX package walks the traced jaxpr; the port walks the
``torch.export.ExportedProgram`` of the same forward after
``run_decompositions()`` (core ATen), with its ``while_loop`` nodes, and
maps each operator to ONNX nodes at opset 18. It emits only the op types
the JAX converter emits (``paddle_tpu/onnx/convert.py`` ``_SIMPLE`` and the
branches of ``convert_eqn``), so one evaluator reads both packages' files:
a view is a ``Reshape`` to its static shape, ``layer_norm``, ``softmax``,
``gelu`` and ``relu`` are spelled in elementwise ops and reductions, ``index_put`` is a ``ScatterND``, ``embedding`` and
``index_select`` a ``Gather``, and a ``while_loop`` an ONNX ``Loop`` whose
first condition runs inline and whose body re-evaluates the condition on
the fresh carry (``_while``, the JAX converter's ``:468``). Every shape is
static (the trace runs at the example's sizes), as in the JAX package.

An operator with no mapping raises ``NotImplementedError`` naming it:
``cond`` (the JAX converter has no rule for ``lax.cond``/``switch``),
K1's ``paddle_tpu_torch::flash_fwd`` (``onnx.export`` traces with K1 off)
and anything else not listed here.
"""
from __future__ import annotations

import operator
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import wire

_SIMPLE = {
    "add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
    "maximum": "Max", "minimum": "Min", "neg": "Neg", "exp": "Exp",
    "log": "Log", "tanh": "Tanh", "sigmoid": "Sigmoid", "sqrt": "Sqrt",
    "abs": "Abs", "erf": "Erf", "sign": "Sign", "floor": "Floor",
    "ceil": "Ceil", "sin": "Sin", "cos": "Cos", "reciprocal": "Reciprocal",
    "pow": "Pow", "lt": "Less", "gt": "Greater", "le": "LessOrEqual",
    "ge": "GreaterOrEqual", "eq": "Equal", "logical_and": "And",
    "logical_or": "Or", "logical_xor": "Xor", "bitwise_and": "And",
    "bitwise_or": "Or", "bitwise_xor": "Xor",
}
_COMPARE = {"lt", "gt", "le", "ge", "eq", "ne"}
_IDENTITY = {"clone", "alias", "detach", "lift_fresh_copy", "contiguous",
             "dropout"}
_RESHAPE = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
            "flatten", "expand_as"}
_SKIP = {"_assert_tensor_metadata", "_assert_scalar", "sym_constrain_range",
         "sym_constrain_range_for_size", "_assert_async", "promote_types"}

# the op types the JAX converter emits (paddle_tpu/onnx/convert.py)
JAX_OP_TYPES = frozenset({
    "Add", "Sub", "Mul", "Div", "Max", "Min", "Pow", "Neg", "Exp", "Log",
    "Tanh", "Sigmoid", "Sqrt", "Abs", "Erf", "Sign", "Floor", "Ceil",
    "Identity", "Reciprocal", "MatMul", "Reshape", "Expand", "Squeeze",
    "Transpose", "Cast", "ReduceSum", "ReduceMax", "ReduceMin",
    "ReduceMean", "ReduceProd", "Slice", "Pad", "Clip", "Conv", "MaxPool",
    "Where", "Concat", "Greater", "Less", "GreaterOrEqual", "LessOrEqual",
    "Equal", "Not", "Sin", "Cos", "Split", "And", "Or", "Xor", "Mod",
    "ArgMax", "ArgMin", "ScatterND", "Gather", "CumSum", "Loop"})


def _np_dtype(dt: torch.dtype) -> np.dtype:
    if dt == torch.bfloat16:
        raise NotImplementedError("onnx export: bfloat16 values (export in "
                                  "float32, as generate() runs)")
    return np.dtype(torch.empty((), dtype=dt).numpy().dtype)


def _meta(node):
    v = node.meta.get("val") if hasattr(node, "meta") else None
    return v


class _Converter:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.types: List[str] = []
        self._uid = 0

    def fresh(self, tag="t"):
        self._uid += 1
        return f"{tag}_{self._uid}"

    def const(self, arr, name=None) -> str:
        name = name or self.fresh("const")
        self.initializers.append(wire.tensor_proto(name, np.asarray(arr)))
        return name

    def emit(self, op, inputs, n_out=1, attrs=()):
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append(wire.node_proto(op, inputs, outs,
                                          name=self.fresh("n"),
                                          attrs=list(attrs)))
        self.types.append(op)
        return outs

    def ints(self, vals) -> str:
        return self.const(np.asarray(list(vals), np.int64))

    def cast(self, name: str, src: torch.dtype, dst: torch.dtype) -> str:
        if src == dst:
            return name
        (out,) = self.emit("Cast", [name], attrs=[
            wire.attr_int("to", wire.onnx_dtype(_np_dtype(dst)))])
        return out

    # ----------------------------------------------------------- values
    def arg(self, env, a, dtype: torch.dtype = None) -> str:
        """The ONNX name of ``a`` (a graph node or a Python scalar), cast
        to ``dtype`` when given."""
        if isinstance(a, torch.fx.Node):
            name = env[a]
            if dtype is not None:
                return self.cast(name, _meta(a).dtype, dtype)
            return name
        if dtype is None:
            raise NotImplementedError(f"onnx export: untyped scalar {a!r}")
        return self.const(np.asarray(a, _np_dtype(dtype)))

    def _result_type(self, args) -> torch.dtype:
        """torch's promotion over tensor nodes and Python scalars."""
        vals = []
        for a in args:
            if isinstance(a, torch.fx.Node):
                m = _meta(a)
                vals.append(torch.empty((), dtype=m.dtype) if m.dim() == 0
                            else torch.empty((1,), dtype=m.dtype))
            else:
                vals.append(a)
        return torch.result_type(*vals) if len(vals) > 1 else vals[0].dtype

    # ------------------------------------------------------------ graph
    def convert_graph(self, gm: torch.fx.GraphModule, inputs: Sequence[str]):
        """Walk ``gm``: its placeholders take ``inputs`` in order; returns
        the ONNX names of its outputs."""
        env: Dict[torch.fx.Node, object] = {}
        it = iter(inputs)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(it)
            elif node.op == "get_attr":
                env[node] = getattr(gm, node.target)
            elif node.op == "call_function":
                out = self.convert_node(gm, env, node)
                if out is not None:
                    env[node] = out
            elif node.op == "output":
                outs = node.args[0]
                outs = outs if isinstance(outs, (list, tuple)) else [outs]
                return [env[o] if isinstance(o, torch.fx.Node) else
                        self.const(np.asarray(o)) for o in outs]
        raise ValueError("onnx export: graph without an output")

    def convert_node(self, gm, env, node):
        t = node.target
        if t is operator.getitem:
            src = env[node.args[0]]
            return src[node.args[1]]
        if isinstance(t, torch._ops.HigherOrderOperator):
            if t.name() == "while_loop":
                return self._while(gm, env, node)
            raise NotImplementedError(
                f"onnx export: operator {t.name()!r} (a higher-order op of "
                "the exported graph) has no ONNX mapping: the JAX converter "
                "has no rule for lax.cond/switch either")
        if not isinstance(t, torch._ops.OpOverload):
            raise NotImplementedError(
                f"onnx export: operator {t!r} has no ONNX mapping yet "
                "(primitive of the exported graph)")
        ns = t.namespace
        op = t._schema.name.split("::")[-1]
        if ns != "aten":
            raise NotImplementedError(
                f"onnx export: operator '{ns}::{op}' has no ONNX mapping "
                "(primitive of the exported graph; K1's flash_fwd runs only "
                "where onnx.export turns it off)")
        if op in _SKIP:
            return None
        fn = getattr(self, "_op_" + op, None)
        if fn is not None:
            return fn(env, node, *node.args, **node.kwargs)
        if op in _IDENTITY:
            return self.emit("Identity", [env[node.args[0]]])[0]
        if op in _RESHAPE:
            return self._reshape(env[node.args[0]], _meta(node).shape)
        if op in _SIMPLE or op == "ne":
            return self._elementwise(env, node, op)
        raise NotImplementedError(
            f"onnx export: operator 'aten::{op}' has no ONNX mapping yet "
            "(primitive of the exported graph)")

    # ----------------------------------------------------- elementwise
    def _elementwise(self, env, node, op):
        args = [a for a in node.args if isinstance(a, (torch.fx.Node, int,
                                                       float, bool))]
        alpha = node.kwargs.get("alpha")
        if op in _COMPARE:
            dt = self._result_type(args)
            ins = [self.arg(env, a, dt) for a in args]
            if op == "ne":
                (e,) = self.emit("Equal", ins)
                return self.emit("Not", [e])[0]
            return self.emit(_SIMPLE[op], ins)[0]
        dt = _meta(node).dtype
        if op == "pow" and not isinstance(args[1], torch.fx.Node):
            ins = [self.arg(env, args[0], dt),
                   self.const(np.asarray(args[1], _np_dtype(dt)))]
            return self.emit("Pow", ins)[0]
        if op == "pow" and not isinstance(args[0], torch.fx.Node):
            ins = [self.const(np.asarray(args[0], _np_dtype(dt))),
                   self.arg(env, args[1], dt)]
            return self.emit("Pow", ins)[0]
        ins = [self.arg(env, a, dt) for a in args]
        if alpha is not None and alpha != 1:
            (ins[1],) = self.emit("Mul", [ins[1], self.const(
                np.asarray(alpha, _np_dtype(dt)))])
        return self.emit(_SIMPLE[op], ins)[0]

    def _op_rsqrt(self, env, node, x):
        (s,) = self.emit("Sqrt", [env[x]])
        return self.emit("Reciprocal", [s])[0]

    def _op_relu(self, env, node, x):
        zero = self.const(np.asarray(0, _np_dtype(_meta(node).dtype)))
        return self.emit("Max", [env[x], zero])[0]

    def _op_gelu(self, env, node, x, approximate="none"):
        dt = _np_dtype(_meta(node).dtype)
        c = lambda v: self.const(np.asarray(v, dt))  # noqa: E731
        x = env[x]
        if approximate == "tanh":
            (x3,) = self.emit("Mul", [x, x])
            (x3,) = self.emit("Mul", [x3, x])
            (a,) = self.emit("Mul", [x3, c(0.044715)])
            (a,) = self.emit("Add", [x, a])
            (a,) = self.emit("Mul", [a, c(np.sqrt(2.0 / np.pi))])
            (t,) = self.emit("Tanh", [a])
        else:
            (a,) = self.emit("Mul", [x, c(1.0 / np.sqrt(2.0))])
            (t,) = self.emit("Erf", [a])
        (t,) = self.emit("Add", [t, c(1.0)])
        (h,) = self.emit("Mul", [x, c(0.5)])
        return self.emit("Mul", [h, t])[0]

    def _op_clamp(self, env, node, x, lo=None, hi=None):
        dt = _np_dtype(_meta(node).dtype)
        out = env[x]
        if lo is not None:
            (out,) = self.emit("Max", [out, self.const(np.asarray(lo, dt))])
        if hi is not None:
            (out,) = self.emit("Min", [out, self.const(np.asarray(hi, dt))])
        return out

    def _op_where(self, env, node, c, a, b):
        dt = _meta(node).dtype
        return self.emit("Where", [env[c], self.arg(env, a, dt),
                                   self.arg(env, b, dt)])[0]

    def _op_logical_not(self, env, node, x):
        return self.emit("Not", [self.arg(env, x, torch.bool)])[0]

    _op_bitwise_not = _op_logical_not

    def _op_remainder(self, env, node, a, b):
        dt = _meta(node).dtype
        if dt.is_floating_point:
            # torch's remainder takes the divisor's sign: a - floor(a/b)*b
            x, y = self.arg(env, a, dt), self.arg(env, b, dt)
            (q,) = self.emit("Div", [x, y])
            (q,) = self.emit("Floor", [q])
            (q,) = self.emit("Mul", [q, y])
            return self.emit("Sub", [x, q])[0]
        return self.emit("Mod", [self.arg(env, a, dt), self.arg(env, b, dt)],
                         attrs=[wire.attr_int("fmod", 0)])[0]

    def _op_div(self, env, node, a, b, rounding_mode=None):
        dt = _meta(node).dtype
        x, y = self.arg(env, a, dt), self.arg(env, b, dt)
        (q,) = self.emit("Div", [x, y])
        if rounding_mode == "floor" and dt.is_floating_point:
            (q,) = self.emit("Floor", [q])
        elif rounding_mode == "floor":
            raise NotImplementedError("onnx export: integer floor division")
        return q

    def _op__to_copy(self, env, node, x, **kw):
        return self.cast(env[x], _meta(x).dtype, _meta(node).dtype) \
            if _meta(x).dtype != _meta(node).dtype else \
            self.emit("Identity", [env[x]])[0]

    # ----------------------------------------------------- constants
    def _filled(self, node, value):
        v = _meta(node)
        one = self.const(np.asarray(value, _np_dtype(v.dtype)))
        if v.dim() == 0:
            return self.emit("Identity", [one])[0]
        return self.emit("Expand", [one, self.ints(v.shape)])[0]

    def _op_full(self, env, node, size, value, **kw):
        return self._filled(node, value)

    def _op_scalar_tensor(self, env, node, value, **kw):
        return self._filled(node, value)

    def _op_arange(self, env, node, *args, **kw):
        nums = [a for a in args if not isinstance(a, torch.fx.Node)]
        if len(nums) != len(args):
            raise NotImplementedError("onnx export: arange with traced ends")
        v = _meta(node)
        return self.const(np.arange(*nums).astype(_np_dtype(v.dtype)))

    # ---------------------------------------------------------- shapes
    def _reshape(self, x, shape):
        return self.emit("Reshape", [x, self.ints(shape)])[0]

    def _op_permute(self, env, node, x, dims):
        nd = _meta(x).dim()
        return self.emit("Transpose", [env[x]], attrs=[wire.attr_ints(
            "perm", [d % nd for d in dims])])[0]

    def _op_expand(self, env, node, x, size, implicit=False):
        return self.emit("Expand", [env[x], self.ints(_meta(node).shape)])[0]

    def _op_slice(self, env, node, x, dim=0, start=None, end=None, step=1):
        n = _meta(x).shape[dim]
        start, stop, step = slice(start, end, step).indices(n)
        return self.emit("Slice", [env[x], self.ints([start]),
                                   self.ints([stop]), self.ints([dim]),
                                   self.ints([step])])[0]

    def _op_select(self, env, node, x, dim, index):
        n = _meta(x).shape[dim]
        idx = self.const(np.asarray(index % n, np.int64))
        return self.emit("Gather", [env[x], idx],
                         attrs=[wire.attr_int("axis", dim)])[0]

    def _op_cat(self, env, node, xs, dim=0):
        dt = _meta(node).dtype
        nd = _meta(node).dim()
        ins = [self.arg(env, x, dt) for x in xs
               if _meta(x).numel() or _meta(x).dim() == nd]
        return self.emit("Concat", ins,
                         attrs=[wire.attr_int("axis", dim % nd)])[0]

    def _split(self, env, node, x, sizes, dim):
        nd = _meta(x).dim()
        outs = self.emit("Split", [env[x], self.ints(sizes)],
                         n_out=len(sizes),
                         attrs=[wire.attr_int("axis", dim % nd)])
        return outs

    def _op_split_with_sizes(self, env, node, x, sizes, dim=0):
        return self._split(env, node, x, sizes, dim)

    def _op_split(self, env, node, x, size, dim=0):
        n = _meta(x).shape[dim]
        sizes = [min(size, n - s) for s in range(0, n, size)]
        return self._split(env, node, x, sizes, dim)

    def _op_constant_pad_nd(self, env, node, x, pad, value=0):
        nd = _meta(x).dim()
        lo, hi = [0] * nd, [0] * nd
        for i in range(len(pad) // 2):
            lo[nd - 1 - i], hi[nd - 1 - i] = pad[2 * i], pad[2 * i + 1]
        dt = _np_dtype(_meta(x).dtype)
        return self.emit("Pad", [env[x], self.ints(lo + hi),
                                 self.const(np.asarray(value, dt))],
                         attrs=[wire.attr_str("mode", "constant")])[0]

    # ------------------------------------------------------ reductions
    def _reduce(self, env, node, kind, x, dims, keepdim):
        nd = _meta(x).dim()
        dims = list(range(nd)) if dims is None or not len(dims) else \
            [d % nd for d in dims]
        return self.emit(kind, [env[x], self.ints(dims)], attrs=[
            wire.attr_int("keepdims", int(bool(keepdim)))])[0]

    def _op_sum(self, env, node, x, dims=None, keepdim=False, dtype=None):
        dt = _meta(node).dtype
        x_name = self.arg(env, x, dt)
        env = dict(env)
        env[x] = x_name
        return self._reduce(env, node, "ReduceSum", x, dims, keepdim)

    def _op_mean(self, env, node, x, dims=None, keepdim=False, dtype=None):
        return self._reduce(env, node, "ReduceMean", x, dims, keepdim)

    def _op_amax(self, env, node, x, dims=(), keepdim=False):
        return self._reduce(env, node, "ReduceMax", x, dims, keepdim)

    def _op_amin(self, env, node, x, dims=(), keepdim=False):
        return self._reduce(env, node, "ReduceMin", x, dims, keepdim)

    def _op_argmax(self, env, node, x, dim=None, keepdim=False, op="ArgMax"):
        src = env[x]
        if dim is None:
            (src,) = self.emit("Reshape", [src, self.ints([-1])])
            dim = 0
        return self.emit(op, [src], attrs=[
            wire.attr_int("axis", dim % max(_meta(x).dim(), 1)),
            wire.attr_int("keepdims", int(bool(keepdim)))])[0]

    def _op_argmin(self, env, node, x, dim=None, keepdim=False):
        return self._op_argmax(env, node, x, dim, keepdim, op="ArgMin")

    def _op_cumsum(self, env, node, x, dim, dtype=None):
        dt = _meta(node).dtype
        return self.emit("CumSum", [self.arg(env, x, dt), self.ints([dim])],
                         attrs=[wire.attr_int("reverse", 0)])[0]

    def _op__softmax(self, env, node, x, dim, half_to_float=False):
        x = env[x]
        (m,) = self.emit("ReduceMax", [x, self.ints([dim])],
                         attrs=[wire.attr_int("keepdims", 1)])
        (d,) = self.emit("Sub", [x, m])
        (e,) = self.emit("Exp", [d])
        (s,) = self.emit("ReduceSum", [e, self.ints([dim])],
                         attrs=[wire.attr_int("keepdims", 1)])
        return self.emit("Div", [e, s])[0]

    # ----------------------------------------------------------- norms
    def _op_native_layer_norm(self, env, node, x, shape, w, b, eps):
        nd = _meta(x).dim()
        axes = list(range(nd - len(shape), nd))
        dt = _np_dtype(_meta(x).dtype)
        x = env[x]
        (mean,) = self.emit("ReduceMean", [x, self.ints(axes)],
                            attrs=[wire.attr_int("keepdims", 1)])
        (d,) = self.emit("Sub", [x, mean])
        (sq,) = self.emit("Mul", [d, d])
        (var,) = self.emit("ReduceMean", [sq, self.ints(axes)],
                           attrs=[wire.attr_int("keepdims", 1)])
        (var,) = self.emit("Add", [var, self.const(np.asarray(eps, dt))])
        (std,) = self.emit("Sqrt", [var])
        (rstd,) = self.emit("Reciprocal", [std])
        (y,) = self.emit("Mul", [d, rstd])
        if w is not None:
            (y,) = self.emit("Mul", [y, env[w]])
        if b is not None:
            (y,) = self.emit("Add", [y, env[b]])
        return (y, mean, rstd)

    # --------------------------------------------------------- products
    def _op_mm(self, env, node, a, b):
        return self.emit("MatMul", [env[a], env[b]])[0]

    _op_bmm = _op_mm

    def _op_addmm(self, env, node, bias, a, b, beta=1, alpha=1):
        if beta != 1 or alpha != 1:
            raise NotImplementedError("onnx export: addmm with alpha/beta")
        (p,) = self.emit("MatMul", [env[a], env[b]])
        return self.emit("Add", [p, env[bias]])[0]

    def _op_convolution(self, env, node, x, w, b, stride, padding, dilation,
                        transposed, output_padding, groups):
        if transposed:
            raise NotImplementedError(
                "onnx export: transposed conv is not mapped to ONNX Conv")
        nd = len(stride)
        attrs = [wire.attr_ints("strides", stride),
                 wire.attr_ints("dilations", dilation),
                 wire.attr_int("group", groups),
                 wire.attr_ints("pads", list(padding) * 2 if len(padding)
                                == nd else list(padding))]
        ins = [env[x], env[w]] + ([env[b]] if b is not None else [])
        return self.emit("Conv", ins, attrs=attrs)[0]

    def _op_max_pool2d_with_indices(self, env, node, x, kernel, stride=(),
                                    padding=0, dilation=1, ceil_mode=False):
        if ceil_mode:
            raise NotImplementedError("onnx export: ceil-mode max pool")
        kernel = list(kernel) if isinstance(kernel, (list, tuple)) \
            else [kernel] * 2
        stride = list(stride) if stride else kernel
        stride = stride * 2 if len(stride) == 1 else stride
        padding = list(padding) if isinstance(padding, (list, tuple)) \
            else [padding] * 2
        padding = padding * 2 if len(padding) == 1 else padding
        (y,) = self.emit("MaxPool", [env[x]], attrs=[
            wire.attr_ints("kernel_shape", kernel),
            wire.attr_ints("strides", stride),
            wire.attr_ints("pads", padding + padding)])
        return (y, None)

    # ---------------------------------------------------------- indexing
    def _op_embedding(self, env, node, w, ids, *a):
        return self.emit("Gather", [env[w], env[ids]],
                         attrs=[wire.attr_int("axis", 0)])[0]

    def _op_index_select(self, env, node, x, dim, idx):
        return self.emit("Gather", [env[x], env[idx]],
                         attrs=[wire.attr_int(
                             "axis", dim % _meta(x).dim())])[0]

    def _one_index(self, x, indices):
        pos = [i for i, t in enumerate(indices) if t is not None]
        if len(pos) != 1 or any(t is not None for t in indices[pos[0] + 1:]):
            raise NotImplementedError(
                "onnx export: indexing by more than one index tensor")
        return pos[0], indices[pos[0]]

    def _op_index_put(self, env, node, x, indices, values, accumulate=False):
        """``x[(:,)*d + (idx,)] = values`` as a ScatterND on ``x`` with dim
        ``d`` moved first (the JAX converter's dynamic_update_slice)."""
        if accumulate:
            raise NotImplementedError("onnx export: index_put accumulate")
        d, idx = self._one_index(x, indices)
        xm, im = _meta(x), _meta(idx)
        nd = xm.dim()
        perm = [d] + [i for i in range(nd) if i != d]
        inv = [perm.index(i) for i in range(nd)]
        want = list(xm.shape[:d]) + list(im.shape) + list(xm.shape[d + 1:])
        vals = self.arg(env, values, xm.dtype)
        if tuple(_meta(values).shape) != tuple(want):
            (vals,) = self.emit("Expand", [vals, self.ints(want)])
        xs = env[x]
        if d:
            (xs,) = self.emit("Transpose", [xs],
                              attrs=[wire.attr_ints("perm", perm)])
            vperm = (list(range(d, d + im.dim())) + list(range(d))
                     + list(range(d + im.dim(), len(want))))
            (vals,) = self.emit("Transpose", [vals],
                                attrs=[wire.attr_ints("perm", vperm)])
        ids = self.cast(env[idx], im.dtype, torch.int64)
        (ids,) = self.emit("Reshape", [ids, self.ints(list(im.shape) + [1])])
        (out,) = self.emit("ScatterND", [xs, ids, vals])
        if d:
            (out,) = self.emit("Transpose", [out],
                               attrs=[wire.attr_ints("perm", inv)])
        return out

    # ------------------------------------------------------ while loop
    def _body_io(self, metas, tag):
        names, infos = [], []
        for m in metas:
            nm = self.fresh(tag)
            names.append(nm)
            infos.append(wire.value_info(nm, _np_dtype(m.dtype),
                                         tuple(m.shape)))
        return names, infos

    def _subgraph_nodes(self, build):
        """``build()`` with the nodes redirected to a fresh list; constants
        still land on the outer graph (a subgraph may read outer-scope
        names)."""
        saved, self.nodes = self.nodes, []
        try:
            build()
            return self.nodes
        finally:
            self.nodes = saved

    def _while(self, gm, env, node):
        """``while_loop(cond, body, carried, extra)`` → ``Loop``: the first
        condition inline on the outer graph; the body re-evaluates the
        condition on the fresh carry; the extra inputs are outer-scope
        names (the JAX converter's ``_while``)."""
        cond_gm, body_gm, carried, extra = node.args[:4]
        cond_gm, body_gm = env[cond_gm], env[body_gm]
        init = [env[c] for c in carried]
        ext = [env[e] for e in extra]
        (cond0,) = self.convert_graph(cond_gm, init + ext)
        iter_nm, cond_in = self.fresh("iter"), self.fresh("cond_in")
        metas = [_meta(c) for c in carried]
        carry_nms, carry_infos = self._body_io(metas, "wcarry")

        def build():
            new = self.convert_graph(body_gm, carry_nms + ext)
            (c_out,) = self.convert_graph(cond_gm, list(new) + ext)
            # every body output is produced by a body node (a passthrough
            # carry would otherwise name a subgraph input)
            build.outs = [self.emit("Identity", [nm])[0]
                          for nm in [c_out] + list(new)]

        body_nodes = self._subgraph_nodes(build)
        out_infos = [wire.value_info(build.outs[0], np.dtype(np.bool_), ())]
        for m, nm in zip(metas, build.outs[1:]):
            out_infos.append(wire.value_info(nm, _np_dtype(m.dtype),
                                             tuple(m.shape)))
        body = wire.graph_proto(
            self.fresh("while_body"), body_nodes,
            [wire.value_info(iter_nm, np.dtype(np.int64), ()),
             wire.value_info(cond_in, np.dtype(np.bool_), ())]
            + carry_infos, out_infos, [])
        return self.emit("Loop", ["", cond0] + init, n_out=len(init),
                         attrs=[wire.attr_graph("body", body)])


def program_to_model(ep, input_names: Sequence[str], input_dims,
                     n_params: int, param_values: Sequence[torch.Tensor],
                     graph_name: str = "paddle_tpu_graph",
                     opset: int = 18):
    """A decomposed ``ExportedProgram`` of ``pure(params, *xs)`` → (the
    serialized ModelProto, the op types it holds). Its first ``n_params``
    user inputs are the parameters (written as initializers with
    ``param_values``), the rest the model's inputs (``input_dims``: their
    dims, ``None`` for a ``dim_param``)."""
    from torch.export.graph_signature import InputKind, OutputKind

    gm = ep.graph_module
    conv = _Converter()
    sig = ep.graph_signature
    names = []
    inputs = []
    user = iter(range(len(input_names) + n_params))
    params = list(param_values)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, spec in zip(placeholders, sig.input_specs):
        if spec.kind == InputKind.USER_INPUT:
            k = next(user)
            if k < n_params:
                names.append(conv.const(
                    params[k].detach().cpu().numpy(), name=f"param_{k}"))
                continue
            j = k - n_params
            m = _meta(node)
            inputs.append(wire.value_info(input_names[j],
                                          _np_dtype(m.dtype), input_dims[j]))
            names.append(input_names[j])
        elif spec.kind == InputKind.TOKEN:  # a side-effect token
            names.append("")
        else:
            value = (ep.state_dict.get(spec.target)
                     if spec.target in ep.state_dict
                     else ep.constants[spec.target])
            names.append(conv.const(value.detach().cpu().numpy()))
    outs = conv.convert_graph(gm, names)
    user_outs = [o for o, s in zip(outs, sig.output_specs)
                 if s.kind == OutputKind.USER_OUTPUT]
    out_nodes = [a for a, s in zip(
        next(n for n in gm.graph.nodes if n.op == "output").args[0],
        sig.output_specs) if s.kind == OutputKind.USER_OUTPUT]
    outputs = []
    for nm, node in zip(user_outs, out_nodes):
        m = _meta(node)
        (nm2,) = conv.emit("Identity", [nm])  # a graph output is a node's
        outputs.append(wire.value_info(nm2, _np_dtype(m.dtype),
                                       tuple(m.shape)))
    graph = wire.graph_proto(graph_name, conv.nodes, inputs, outputs,
                             conv.initializers)
    return wire.model_proto(graph, opset=opset), conv.types
