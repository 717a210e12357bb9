"""Explicit-stream collective variants (reference:
``communication/stream/``; ``paddle_tpu/distributed/communication/
stream/__init__.py``).

Every collective of the port has finished on the caller's stream when
it returns (``torch.distributed`` makes the current stream wait for the
communication), so ``sync_op`` and ``use_calc_stream`` are taken and
change nothing: scripts written against the stream API run unchanged.
"""
import functools as _functools

from ... import collective as _c

__all__ = ["all_gather", "all_reduce", "alltoall", "all_to_all",
           "alltoall_single", "broadcast", "gather", "recv", "reduce",
           "reduce_scatter", "scatter", "send"]


def _stream_variant(fn):
    @_functools.wraps(fn)
    def wrapper(*args, sync_op=True, use_calc_stream=False, **kwargs):
        return fn(*args, **kwargs)

    return wrapper


all_gather = _stream_variant(_c.all_gather)
all_reduce = _stream_variant(_c.all_reduce)
alltoall = _stream_variant(_c.alltoall)
all_to_all = alltoall


def alltoall_single(out_tensor, in_tensor, out_split_sizes=None,
                    in_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    """The reference stream signature is (out_tensor, in_tensor, ...),
    the reverse of ``paddle.distributed.alltoall_single``'s."""
    from ...misc import alltoall_single as _fn

    return _fn(in_tensor, out_tensor, in_split_sizes=in_split_sizes,
               out_split_sizes=out_split_sizes, group=group)


broadcast = _stream_variant(_c.broadcast)
gather = _stream_variant(_c.gather)
recv = _stream_variant(_c.recv)
reduce = _stream_variant(_c.reduce)
reduce_scatter = _stream_variant(_c.reduce_scatter)
scatter = _stream_variant(_c.scatter)
send = _stream_variant(_c.send)
