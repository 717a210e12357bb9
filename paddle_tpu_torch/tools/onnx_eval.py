"""A small numpy evaluator of the ONNX files that ``paddle_tpu_torch.onnx``
and ``paddle_tpu.onnx`` write: the op types their converters emit
(``onnx/convert.py`` ``JAX_OP_TYPES``), ``Loop`` with outer-scope names and
scan outputs, ``Conv``, ``MaxPool``, ``ScatterND`` and ``Gather`` among
them. It reads a file with the port's wire reader (``onnx/wire.py``), so
it needs neither the ``onnx`` package nor a runtime. A check tool of the
tests and of ``chip_smoke.py``, not a public API.

    from paddle_tpu_torch.tools import onnx_eval
    outs = onnx_eval.run("model.onnx", {"tokens": ids, "cur_len": cur})
    python -m paddle_tpu_torch.tools.onnx_eval model.onnx   # list its ops
"""
from __future__ import annotations

import struct
import sys
from collections import ChainMap, Counter
from typing import Dict, List

import numpy as np

from ..onnx import wire

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def _varints(b: bytes) -> List[int]:
    out, v, shift = [], 0, 0
    for byte in b:
        v |= (byte & 0x7F) << shift
        if byte & 0x80:
            shift += 7
        else:
            out.append(v - (1 << 64) if v >= 1 << 63 else v)
            v, shift = 0, 0
    return out


def _ints(field) -> List[int]:
    """A repeated int64 field: packed bytes, or varints one by one."""
    out = []
    for item in field:
        if isinstance(item, (bytes, bytearray, memoryview)):
            out += _varints(item)
        else:
            out.append(item - (1 << 64) if item >= 1 << 63 else item)
    return out


def _str(b) -> str:
    return bytes(b).decode()


def _tensor(raw: bytes) -> tuple:
    t = wire.read_message(raw)
    dims = _ints(t.get(1, []))
    dt = _DTYPES[t[2][0]]
    # one aligned, writable copy of the payload (a view into the file is
    # unaligned, and BLAS copies an unaligned operand at every product)
    arr = np.frombuffer(t.get(9, [b""])[0], dtype=dt).reshape(dims).copy()
    return _str(t[8][0]), arr


def _attrs(raws) -> dict:
    out = {}
    for raw in raws:
        a = wire.read_message(raw)
        name, kind = _str(a[1][0]), a.get(20, [0])[0]
        if kind == 1:
            out[name] = struct.unpack("<f", a[2][0])[0]
        elif kind == 2:
            v = a[3][0]
            out[name] = v - (1 << 64) if v >= 1 << 63 else v
        elif kind == 3:
            out[name] = _str(a[4][0])
        elif kind == 4:
            out[name] = _tensor(a[5][0])[1]
        elif kind == 5:
            out[name] = Graph(a[6][0])
        elif kind == 7:
            out[name] = _ints(a.get(8, []))
    return out


class Graph:
    """A parsed GraphProto: nodes ``(op, inputs, outputs, attrs)``,
    initializers, input and output names."""

    def __init__(self, raw: bytes):
        g = wire.read_message(raw)
        self.nodes = []
        for n in g.get(1, []):
            nd = wire.read_message(n)
            self.nodes.append((_str(nd[4][0]),
                               [_str(x) for x in nd.get(1, [])],
                               [_str(x) for x in nd.get(2, [])],
                               _attrs(nd.get(5, []))))
        self.initializers = dict(_tensor(t) for t in g.get(5, []))
        self.inputs = [_str(wire.read_message(v)[1][0])
                       for v in g.get(11, [])]
        self.outputs = [_str(wire.read_message(v)[1][0])
                        for v in g.get(12, [])]

    def op_types(self) -> Counter:
        c = Counter()
        for op, _, _, attrs in self.nodes:
            c[op] += 1
            for v in attrs.values():
                if isinstance(v, Graph):
                    c += v.op_types()
        return c


def load(path_or_bytes) -> Graph:
    raw = path_or_bytes
    if not isinstance(raw, (bytes, bytearray)):
        with open(raw, "rb") as f:
            raw = f.read()
    # slices of a memoryview are views: the graph is not copied whole
    model = wire.read_message(memoryview(raw))
    return Graph(model[7][0])


# ---------------------------------------------------------------- ops
def _div(a, b):
    if np.issubdtype(a.dtype, np.integer):
        q = a // b
        return (q + ((q < 0) & (q * b != a))).astype(a.dtype)
    return (a / b).astype(np.result_type(a, b))


def _erf(x):
    from scipy.special import erf

    return erf(x).astype(x.dtype)


def _reduce(fn):
    def op(x, axes=None, keepdims=1, noop_with_empty_axes=0):
        if axes is None or not len(axes):
            if noop_with_empty_axes:
                return x
            ax = None
        else:
            ax = tuple(int(a) % max(x.ndim, 1) for a in axes)
        return np.asarray(fn(x, axis=ax, keepdims=bool(keepdims))).astype(
            x.dtype)
    return op


def _reshape(x, shape, allowzero=0):
    shape = [int(s) for s in shape]
    if not allowzero:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def _expand(x, shape):
    return np.broadcast_to(x, np.broadcast_shapes(x.shape, tuple(
        int(s) for s in shape))).copy()


def _slice(x, starts, ends, axes=None, steps=None):
    axes = list(range(len(starts))) if axes is None else list(axes)
    steps = [1] * len(starts) if steps is None else list(steps)
    idx = [slice(None)] * x.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        idx[int(a) % x.ndim] = slice(int(s), int(e), int(st))
    return x[tuple(idx)]


def _pad(x, pads, value=None, mode="constant"):
    n = x.ndim
    width = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    cv = 0 if value is None else value.item()
    return np.pad(x, width, mode="constant", constant_values=cv)


def _clip(x, lo=None, hi=None):
    if lo is not None:
        x = np.maximum(x, lo)
    if hi is not None:
        x = np.minimum(x, hi)
    return x


def _windows(x, kernel, strides, pads, dilations, fill):
    """[N, C, Ho, Wo, kh, kw] views of padded ``x``."""
    k = len(kernel)
    width = [(0, 0), (0, 0)] + [(pads[i], pads[i + k]) for i in range(k)]
    xp = np.pad(x, width, constant_values=fill)
    span = [(kernel[i] - 1) * dilations[i] + 1 for i in range(k)]
    w = np.lib.stride_tricks.sliding_window_view(xp, span, axis=(2, 3))
    w = w[:, :, ::strides[0], ::strides[1], ::dilations[0], ::dilations[1]]
    return w


def _conv(x, w, b=None, strides=None, pads=None, dilations=None, group=1,
          kernel_shape=None):
    kh, kw = w.shape[2:]
    strides = strides or [1, 1]
    pads = pads or [0, 0, 0, 0]
    dilations = dilations or [1, 1]
    win = _windows(x, [kh, kw], strides, pads, dilations, 0)
    N, C, Ho, Wo = win.shape[:4]
    G = int(group)
    O = w.shape[0]
    win = win.reshape(N, G, C // G, Ho, Wo, kh, kw)
    wg = w.reshape(G, O // G, C // G, kh, kw)
    out = np.einsum("ngchwij,gocij->ngohw", win, wg, optimize=True)
    out = out.reshape(N, O, Ho, Wo).astype(x.dtype)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


def _maxpool(x, kernel_shape, strides=None, pads=None, dilations=None,
             ceil_mode=0):
    strides = strides or [1, 1]
    pads = pads or [0, 0, 0, 0]
    dilations = dilations or [1, 1]
    win = _windows(x, kernel_shape, strides, pads, dilations, -np.inf)
    return win.max(axis=(-2, -1)).astype(x.dtype)


def _scatter_nd(data, indices, updates, reduction="none"):
    out = data.copy()
    k = indices.shape[-1]
    idx = indices.reshape(-1, k)
    upd = updates.reshape((idx.shape[0],) + data.shape[k:])
    for i in range(idx.shape[0]):
        out[tuple(idx[i])] = upd[i]
    return out


def _arg(fn):
    def op(x, axis=0, keepdims=1, select_last_index=0):
        out = fn(x, axis=int(axis))
        if keepdims:
            out = np.expand_dims(out, int(axis))
        return out.astype(np.int64)
    return op


def _cumsum(x, axis, exclusive=0, reverse=0):
    ax = int(np.asarray(axis).reshape(()))
    y = np.flip(x, ax) if reverse else x
    out = np.cumsum(y, axis=ax, dtype=x.dtype)
    if exclusive:
        out = out - y
    return np.flip(out, ax) if reverse else out


def _split(x, split=None, axis=0, num_outputs=None):
    points = np.cumsum([int(s) for s in split])[:-1]
    return np.split(x, points, axis=int(axis))


_OPS = {
    "Add": lambda a, b: a + b, "Sub": lambda a, b: a - b,
    "Mul": lambda a, b: a * b, "Div": _div,
    "Max": lambda *xs: np.maximum.reduce(np.broadcast_arrays(*xs)),
    "Min": lambda *xs: np.minimum.reduce(np.broadcast_arrays(*xs)),
    "Pow": lambda a, b: np.power(a, b).astype(a.dtype),
    "Neg": np.negative, "Exp": np.exp, "Log": np.log, "Tanh": np.tanh,
    "Sigmoid": lambda x: (1 / (1 + np.exp(-x))).astype(x.dtype),
    "Sqrt": np.sqrt, "Abs": np.abs, "Erf": _erf, "Sign": np.sign,
    "Floor": np.floor, "Ceil": np.ceil, "Sin": np.sin, "Cos": np.cos,
    "Identity": lambda x: x,
    "Reciprocal": lambda x: (1 / x).astype(x.dtype),
    "MatMul": np.matmul, "Reshape": _reshape, "Expand": _expand,
    "Squeeze": lambda x, axes=None: np.squeeze(
        x, None if axes is None else tuple(int(a) for a in axes)),
    "Transpose": lambda x, perm=None: np.transpose(x, perm),
    "Cast": lambda x, to: x.astype(_DTYPES[to]),
    "ReduceSum": _reduce(np.sum), "ReduceMax": _reduce(np.max),
    "ReduceMin": _reduce(np.min), "ReduceMean": _reduce(np.mean),
    "ReduceProd": _reduce(np.prod), "Slice": _slice, "Pad": _pad,
    "Clip": _clip, "Conv": _conv, "MaxPool": _maxpool,
    "Where": np.where,
    "Concat": lambda *xs, axis: np.concatenate(xs, axis=int(axis)),
    "Greater": np.greater, "Less": np.less,
    "GreaterOrEqual": np.greater_equal, "LessOrEqual": np.less_equal,
    "Equal": np.equal, "Not": np.logical_not, "And": np.logical_and,
    "Or": np.logical_or, "Xor": np.logical_xor,
    "Mod": lambda a, b, fmod=0: (np.fmod(a, b) if fmod else np.mod(a, b)),
    "ArgMax": _arg(np.argmax), "ArgMin": _arg(np.argmin),
    "ScatterND": _scatter_nd,
    "Gather": lambda x, i, axis=0: np.take(
        x, np.where(i < 0, i + x.shape[int(axis)], i), axis=int(axis)),
    "CumSum": _cumsum, "Split": _split,
}


def _loop(env, ins, outs, attrs):
    body: Graph = attrs["body"]
    trip = None if ins[0] is None else int(np.asarray(ins[0]).reshape(()))
    go = True if ins[1] is None else bool(np.asarray(ins[1]).reshape(()))
    carry = list(ins[2:])
    n_carry = len(carry)
    scans: List[list] = []
    i = 0
    while go and (trip is None or i < trip):
        vals = _run_graph(body, [np.asarray(i, np.int64), np.asarray(go)]
                          + carry, env)
        go = bool(np.asarray(vals[0]).reshape(()))
        carry = list(vals[1:1 + n_carry])
        ys = vals[1 + n_carry:]
        if not scans:
            scans = [[] for _ in ys]
        for acc, y in zip(scans, ys):
            acc.append(y)
        i += 1
    n_scan = len(outs) - n_carry
    stacked = [np.stack(a) if a else np.zeros((0,), np.float32)
               for a in scans] if scans else [np.zeros((0,), np.float32)
                                              for _ in range(n_scan)]
    return carry + stacked


def _run_graph(g: Graph, inputs, outer=None) -> list:
    env = ChainMap({}, g.initializers, *([outer] if outer is not None
                                         else []))
    for name, v in zip(g.inputs, inputs):
        env.maps[0][name] = v
    for op, ins, outs, attrs in g.nodes:
        vals = [env[n] if n else None for n in ins]
        if op == "Loop":
            res = _loop(env, vals, outs, attrs)
        elif op in ("Slice", "Clip", "Pad"):
            res = _OPS[op](*vals, **attrs)
        else:
            if op not in _OPS:
                raise NotImplementedError(f"onnx_eval: op type {op!r}")
            kw = {k: v for k, v in attrs.items()}
            # opset-18 inputs that older forms carried as attributes
            if op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceMean",
                      "ReduceProd", "Squeeze") and len(vals) > 1:
                kw["axes"] = vals[1]
                vals = vals[:1]
            elif op == "Split" and len(vals) > 1:
                kw["split"] = vals[1]
                vals = vals[:1]
            res = _OPS[op](*[v for v in vals], **kw)
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        for name, v in zip(outs, res):
            env.maps[0][name] = np.asarray(v)
    return [env[n] for n in g.outputs]


def run(path_or_graph, feeds: Dict[str, np.ndarray]) -> list:
    """The model's outputs, in its output order, on ``feeds`` (numpy
    arrays by input name)."""
    g = path_or_graph if isinstance(path_or_graph, Graph) \
        else load(path_or_graph)
    return _run_graph(g, [np.asarray(feeds[n]) for n in g.inputs])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    g = load(argv[0])
    print(dict(g.op_types()), len(g.nodes), "nodes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
