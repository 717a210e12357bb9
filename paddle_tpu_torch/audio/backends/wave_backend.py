"""Stdlib audio backend (``paddle_tpu/audio/backends/wave_backend.py``,
copied): the RIFF container parsed directly, so 8/16/24/32-bit PCM and
float WAVs round-trip without external packages. ``load`` returns a
facade Tensor on the current device.

Encodings: PCM_U8, PCM_S (16/24/32-bit), PCM_F (float32/float64).
"""
from __future__ import annotations

import struct
import wave as _wave
from dataclasses import dataclass

import numpy as np

__all__ = ["AudioInfo", "info", "load", "save", "get_current_backend",
           "list_available_backends", "set_backend"]

_FMT_PCM = 1
_FMT_FLOAT = 3


@dataclass
class AudioInfo:
    sample_rate: int
    num_samples: int
    num_channels: int
    bits_per_sample: int
    encoding: str = "PCM_S"


_current = "wave"


def list_available_backends():
    return ["wave"]


def get_current_backend() -> str:
    return _current


def set_backend(backend_name: str) -> None:
    global _current
    if backend_name not in list_available_backends():
        raise NotImplementedError(
            f"audio backend {backend_name!r} unavailable; only the stdlib "
            "'wave' backend ships in this zero-egress image")
    _current = backend_name


def _read_riff(filepath: str):
    """Parse a RIFF/WAVE file: returns (fmt_tag, channels, sample_rate,
    bits, raw data bytes). Handles PCM and IEEE-float fmt chunks, which the
    stdlib wave module rejects."""
    with open(filepath, "rb") as f:
        riff, _, wav = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wav != b"WAVE":
            raise ValueError(f"{filepath!r} is not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", hdr)
            body = f.read(size)
            if size % 2:
                f.read(1)  # chunks are word-aligned
            if cid == b"fmt ":
                tag, ch, sr, _, _, bits = struct.unpack("<HHIIHH", body[:16])
                if tag == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    tag = struct.unpack("<H", body[24:26])[0]
                fmt = (tag, ch, sr, bits)
            elif cid == b"data":
                data = body
        if fmt is None or data is None:
            raise ValueError(f"{filepath!r}: missing fmt/data chunk")
        return (*fmt, data)


def _decode(tag, ch, bits, raw, normalize):
    if tag == _FMT_FLOAT:
        dt = "<f4" if bits == 32 else "<f8"
        data = np.frombuffer(raw, dtype=dt).reshape(-1, ch)
        return data.astype(np.float32) if normalize else data
    if bits == 8:  # unsigned
        data = np.frombuffer(raw, dtype=np.uint8).reshape(-1, ch)
        return (data.astype(np.float32) - 128.0) / 128.0 if normalize \
            else data
    if bits == 16:
        data = np.frombuffer(raw, dtype="<i2").reshape(-1, ch)
        return data.astype(np.float32) / 32768.0 if normalize else data
    if bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val & 0x800000, val - (1 << 24), val)
        data = val.reshape(-1, ch)
        return data.astype(np.float32) / float(1 << 23) if normalize \
            else data
    if bits == 32:
        data = np.frombuffer(raw, dtype="<i4").reshape(-1, ch)
        return data.astype(np.float32) / float(1 << 31) if normalize \
            else data
    raise NotImplementedError(f"unsupported PCM bit depth {bits}")


def _encoding_name(tag, bits):
    if tag == _FMT_FLOAT:
        return "PCM_F"
    return "PCM_U" if bits == 8 else "PCM_S"


def info(filepath: str) -> AudioInfo:
    tag, ch, sr, bits, data = _read_riff(filepath)
    frame = ch * (bits // 8)
    return AudioInfo(sample_rate=sr, num_samples=len(data) // frame,
                     num_channels=ch, bits_per_sample=bits,
                     encoding=_encoding_name(tag, bits))


def load(filepath: str, frame_offset: int = 0, num_frames: int = -1,
         normalize: bool = True, channels_first: bool = True):
    """Returns (Tensor [C, N] or [N, C], sample_rate)."""
    from ...tensor import Tensor

    tag, ch, sr, bits, raw = _read_riff(filepath)
    data = _decode(tag, ch, bits, raw, normalize)
    if frame_offset:
        data = data[frame_offset:]
    if num_frames >= 0:
        data = data[:num_frames]
    arr = data.T if channels_first else data
    return Tensor(np.ascontiguousarray(arr)), sr


def save(filepath: str, src, sample_rate: int,
         channels_first: bool = True, encoding: str = "PCM_S",
         bits_per_sample: int = 16) -> None:
    data = np.asarray(src.numpy() if hasattr(src, "numpy") else src)
    if data.ndim == 1:
        data = data[:, None]
    elif channels_first:
        data = data.T
    ch = data.shape[1]

    if encoding == "PCM_F":
        bits = 32 if bits_per_sample not in (32, 64) else bits_per_sample
        payload = data.astype("<f4" if bits == 32 else "<f8").tobytes()
        tag = _FMT_FLOAT
    else:
        bits = bits_per_sample
        if data.dtype.kind == "f":
            data = np.clip(data, -1.0, 1.0)
            if bits == 8:
                q = (data * 127.0 + 128.0).astype(np.uint8)
            elif bits == 16:
                q = (data * 32767.0).astype("<i2")
            elif bits == 24:
                q = (data * float((1 << 23) - 1)).astype(np.int32)
            elif bits == 32:
                q = (data * float((1 << 31) - 1)).astype("<i4")
            else:
                raise NotImplementedError(
                    f"unsupported bits_per_sample {bits}")
        else:
            # integer input: cast to the declared sample width so the
            # payload matches the header's block align
            if bits == 8:
                q = data.astype(np.uint8)
            elif bits == 16:
                q = data.astype("<i2")
            elif bits in (24, 32):
                q = data.astype(np.int32 if bits == 24 else "<i4")
            else:
                raise NotImplementedError(
                    f"unsupported bits_per_sample {bits}")
        if bits == 24:
            v = q.astype(np.int32).reshape(-1)
            payload = np.stack([v & 0xFF, (v >> 8) & 0xFF,
                                (v >> 16) & 0xFF],
                               axis=-1).astype(np.uint8).tobytes()
        else:
            payload = np.ascontiguousarray(q).tobytes()
        tag = _FMT_PCM

    block = ch * (bits // 8)
    with open(filepath, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, tag, ch,
                            sample_rate, sample_rate * block, block, bits))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)
