"""Minimal protobuf wire-format writer + the ONNX field schema: a copy of
``paddle_tpu/onnx/wire.py`` (the same field numbers, writers and reader),
so that one reader checks the files both packages write.

The image ships neither the ``onnx`` package nor its generated classes, so
the few message types ONNX needs are emitted directly in wire format (the
encoding is just tag-varint / length-delimited records — onnx.proto field
numbers are stable public schema).

Only what export needs: ModelProto, GraphProto, NodeProto, AttributeProto,
TensorProto, ValueInfoProto (+ TypeProto/TensorShapeProto), and a small
reader used by the tests and ``tools/onnx_eval.py`` to read what was
written.
"""
from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL = 1, 2, 3, 6, 7, 9
FLOAT16, DOUBLE, BFLOAT16 = 10, 11, 16

_NP2ONNX = {
    np.dtype(np.float32): FLOAT, np.dtype(np.float64): DOUBLE,
    np.dtype(np.int32): INT32, np.dtype(np.int64): INT64,
    np.dtype(np.uint8): UINT8, np.dtype(np.int8): INT8,
    np.dtype(np.bool_): BOOL, np.dtype(np.float16): FLOAT16,
}


def onnx_dtype(np_dtype) -> int:
    d = np.dtype(np_dtype)
    if str(d) == "bfloat16":
        return BFLOAT16
    if d not in _NP2ONNX:
        raise NotImplementedError(f"onnx export: unsupported dtype {d}")
    return _NP2ONNX[d]


# ------------------------------------------------------------ wire writing

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def field_str(num: int, s: str) -> bytes:
    return field_bytes(num, s.encode())


def packed_int64s(num: int, vals: Sequence[int]) -> bytes:
    return field_bytes(num, b"".join(_varint(v) for v in vals))


# --------------------------------------------------------------- messages

def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    # the shape of arr itself: np.ascontiguousarray makes a 0-d array 1-d
    shape = np.shape(arr)
    arr = np.ascontiguousarray(arr)
    # joined once over a view of the payload (a GPT-355M weight is 200 MB)
    return b"".join([packed_int64s(1, shape),
                     field_varint(2, onnx_dtype(arr.dtype)),
                     field_str(8, name), _varint(9 << 3 | 2),
                     _varint(arr.nbytes), memoryview(arr).cast("B")])


def _tensor_shape(dims) -> bytes:
    out = b""
    for d in dims:
        if d is None:
            out += field_bytes(1, field_str(2, "N"))  # dim_param (field 2)
        else:
            out += field_bytes(1, field_varint(1, int(d)))
    return out


def value_info(name: str, dtype, dims) -> bytes:
    tensor_type = (field_varint(1, onnx_dtype(dtype))
                   + field_bytes(2, _tensor_shape(dims)))
    return field_str(1, name) + field_bytes(2, field_bytes(1, tensor_type))


def attr_int(name: str, v: int) -> bytes:
    return (field_str(1, name) + field_varint(3, v)
            + field_varint(20, 2))  # AttributeProto.INT


def attr_float(name: str, v: float) -> bytes:
    return (field_str(1, name)
            + _varint(2 << 3 | 5) + struct.pack("<f", v)
            + field_varint(20, 1))  # FLOAT


def attr_ints(name: str, vals: Sequence[int]) -> bytes:
    return (field_str(1, name) + packed_int64s(8, vals)
            + field_varint(20, 7))  # INTS


def attr_str(name: str, s: str) -> bytes:
    return field_str(1, name) + field_bytes(4, s.encode()) \
        + field_varint(20, 3)  # STRING


def attr_tensor(name: str, t: bytes) -> bytes:
    return field_str(1, name) + field_bytes(5, t) + field_varint(20, 4)


def attr_graph(name: str, g: bytes) -> bytes:
    return field_str(1, name) + field_bytes(6, g) + field_varint(20, 5)


def node_proto(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
               name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    out = b""
    for i in inputs:
        out += field_str(1, i)
    for o in outputs:
        out += field_str(2, o)
    if name:
        out += field_str(3, name)
    out += field_str(4, op_type)
    for a in attrs:
        out += field_bytes(5, a)
    return out


def graph_proto(name: str, nodes: List[bytes], inputs: List[bytes],
                outputs: List[bytes], initializers: List[bytes]) -> bytes:
    # joined once: a GPT-355M decode step holds 1.4 GB of initializers
    return b"".join([*(field_bytes(1, n) for n in nodes), field_str(2, name),
                     *(field_bytes(5, t) for t in initializers),
                     *(field_bytes(11, i) for i in inputs),
                     *(field_bytes(12, o) for o in outputs)])


def model_proto(graph: bytes, opset: int = 18,
                producer: str = "paddle-tpu") -> bytes:
    opset_id = field_str(1, "") + field_varint(2, opset)
    return b"".join([field_varint(1, 8),  # ir_version 8
                     field_str(2, producer), field_str(3, "3.0.0"),
                     _varint(7 << 3 | 2), _varint(len(graph)), graph,
                     field_bytes(8, opset_id)])


# ------------------------------------------------------------ mini reader

def read_message(data: bytes):
    """Parse one protobuf message into {field_num: [values]} — varints as
    ints, length-delimited as bytes (recursable), fixed32 as raw bytes."""
    out: dict = {}
    i = 0
    n = len(data)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        num, wt = tag >> 3, tag & 7
        if wt == 0:
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            out.setdefault(num, []).append(v)
        elif wt == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            out.setdefault(num, []).append(data[i:i + ln])
            i += ln
        elif wt == 5:
            out.setdefault(num, []).append(data[i:i + 4])
            i += 4
        elif wt == 1:
            out.setdefault(num, []).append(data[i:i + 8])
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
    return out
