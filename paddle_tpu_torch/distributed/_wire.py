"""Shared TCP wire helpers for the distributed transports (rpc, ps)
(``paddle_tpu/distributed/_wire.py``, copied).

Length-prefixed framing: ``u64 little-endian length | payload``.
"""
from __future__ import annotations

import socket
import struct

__all__ = ["recv_full", "send_msg", "recv_msg", "free_port"]

# 4 GiB: a frame larger than this is a protocol error (or an attack), not
# a legitimate tensor push
MAX_FRAME = 1 << 32


def recv_full(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf += chunk
    return buf


def send_msg(conn: socket.socket, payload: bytes) -> None:
    conn.sendall(struct.pack("<Q", len(payload)) + payload)


def recv_msg(conn: socket.socket) -> bytes:
    (n,) = struct.unpack("<Q", recv_full(conn, 8))
    if n > MAX_FRAME:
        raise ConnectionError(f"oversized frame ({n} bytes)")
    return recv_full(conn, n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
