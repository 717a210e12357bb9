"""Tensor control flow as conditional nodes of a captured CUDA graph.

The JAX package compiles a tensor ``cond``/``case``/``switch_case`` to
``lax.cond``/``lax.switch`` and a tensor ``while`` to ``lax.while_loop``
inside the step's XLA program (``paddle_tpu/static/nn/control_flow.py``).
The port captures a step as one CUDA graph (``jit.StaticFunction``), and
this module puts the control flow into that graph, its predicate read on
the device at every replay:

- :func:`if_nodes` runs ``fns[sel]`` as a chain of IF nodes, one a
  branch (``sel == i``). The first branch's outputs are fresh buffers;
  every other branch copies its outputs into them. Only the chosen
  branch runs.
- :func:`while_node` runs ``body`` while ``cond`` holds as one WHILE
  node. The carry is copied into buffers before the node; the body reads
  them, writes its results back into them (``copy_``) and sets the
  node's condition from the next predicate.

PyTorch on the card (2.11) exposes neither node, so both come from
``csrc/graph_cond.cu``. A body is captured on a stream of its own (one a
nesting depth); its allocations go to a graph pool of its own, by the
capturing thread (PyTorch's ``_cuda_beginAllocateCurrentThreadToPool``,
opened by the outermost body of a thread): what a body allocates lives in
that pool, which is never released, and a temporary freed during the
capture is reused only by later nodes of the capture, which the graph
orders after it.
- :func:`plain_while` is the plain version: the Python loop of the eager
  regime, reading the predicate on the host every trip.

Both need a stream under capture (:func:`capturing`). Nothing falls
back: a failed build, a non-zero ``cudaError_t`` or a driver without
conditional nodes raises. Counts: ``captured_launches`` (WHILE nodes
captured), ``replayed_launches`` (their executions in replays, added by
``StaticFunction`` as for the flash kernels), ``if_captured`` (IF nodes)
and ``plain_calls`` (plain loops on CUDA tensors).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Dict, List, Sequence

import torch

from . import _build
from .. import tensor as _tensor

__all__ = ["capturing", "if_nodes", "while_node", "plain_while",
           "warm_up", "reset_counters"]

captured_launches = 0
replayed_launches = 0
if_captured = 0
plain_calls = 0


def reset_counters() -> None:
    global captured_launches, replayed_launches, if_captured, plain_calls
    captured_launches = replayed_launches = if_captured = plain_calls = 0


def count_replays(n: int) -> None:
    """Record one replay of a graph that holds ``n`` WHILE nodes."""
    global replayed_launches
    replayed_launches += int(n)


def capturing(v) -> bool:
    """Whether ``v`` (a torch tensor) is on the card while its current
    stream is being captured: the conditional-node regime."""
    return (isinstance(v, torch.Tensor) and v.is_cuda
            and torch.cuda.is_current_stream_capturing())


def _lib():
    lib = _build.load("graph_cond")
    if lib.ptc_cond_begin.argtypes is None:
        p = ctypes.c_void_p
        lib.ptc_cond_begin.argtypes = [p, p, p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_ulonglong)]
        lib.ptc_set_conditional.argtypes = [p, ctypes.c_ulonglong, p]
        lib.ptc_cond_end.argtypes = [p]
        for fn in (lib.ptc_cond_begin, lib.ptc_set_conditional,
                   lib.ptc_cond_end):
            fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def _pred(p: torch.Tensor) -> torch.Tensor:
    """``p`` as a contiguous 0-d bool tensor."""
    if p.numel() != 1:
        raise ValueError(
            f"a predicate must hold one element, got shape {tuple(p.shape)}")
    return p.reshape(()).to(torch.bool).contiguous()


# ------------------------------------------------------------ bodies
_body_streams: Dict[int, List[torch.cuda.Stream]] = {}
_body_pools: Dict[int, object] = {}
_local = threading.local()


def _body_pool(dev: torch.device):
    pool = _body_pools.get(dev.index)
    if pool is None:
        pool = _body_pools[dev.index] = torch.cuda.graph_pool_handle()
    return pool


@contextlib.contextmanager
def _body(pred: torch.Tensor, is_while: bool):
    """Capture what the block runs into the body of a new IF or WHILE node
    on ``pred`` (a 0-d bool tensor on the card); yields the node's
    handle and the body's stream."""
    lib = _lib()
    dev = pred.device
    depth = getattr(_local, "depth", 0)
    streams = _body_streams.setdefault(dev.index, [])
    while len(streams) <= depth:
        streams.append(torch.cuda.Stream(dev))
    side = streams[depth]
    stream = torch.cuda.current_stream(dev)
    handle = ctypes.c_ulonglong(0)
    _check(lib.ptc_cond_begin(stream.cuda_stream, side.cuda_stream,
                              pred.data_ptr(), int(is_while),
                              ctypes.byref(handle)),
           "capture of a conditional node")
    pool = _body_pool(dev)
    _local.depth = depth + 1
    _tensor.capturing_bodies += 1
    routed = False
    try:
        if depth == 0:
            torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool)
            routed = True
        with torch.cuda.stream(side):
            yield handle.value, side
    except BaseException:
        lib.ptc_cond_end(side.cuda_stream)  # the error raised is the cause
        raise
    else:
        _check(lib.ptc_cond_end(side.cuda_stream),
               "end of a conditional body's capture")
    finally:
        _local.depth = depth
        _tensor.capturing_bodies -= 1
        if routed:
            torch._C._cuda_endAllocateToPool(dev.index, pool)


# ----------------------------------------------------------------- IF
def if_nodes(sel: torch.Tensor, fns: Sequence[Callable[[], List[torch.Tensor]]]
             ) -> List[torch.Tensor]:
    """``fns[sel]()`` (each returns a list of torch tensors of one
    structure) as IF nodes of the graph being captured (module
    docstring). ``sel`` is a 0-d integer tensor on the card; a value
    outside ``range(len(fns))`` runs no branch."""
    global if_captured
    sel = sel.reshape(())
    outs: List[torch.Tensor] = []
    for i, fn in enumerate(fns):
        with _body(_pred(sel == i), False):
            if_captured += 1
            got = fn()
            if i == 0:
                outs = [o.clone() for o in got]
            else:
                if len(got) != len(outs):
                    raise ValueError(
                        f"branch {i} returned {len(got)} tensors, branch 0 "
                        f"{len(outs)}")
                for o, g in zip(outs, got):
                    o.copy_(g)
    return outs


# -------------------------------------------------------------- WHILE
def while_node(cond: Callable[..., torch.Tensor],
               body: Callable[..., Sequence[torch.Tensor]],
               carry: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The loop ``while cond(*c): c = body(*c)`` over torch tensors as one
    WHILE node of the graph being captured (module docstring). Returns
    the carry buffers, which hold the final values after the node ran."""
    global captured_launches
    bufs = [c.detach().clone() for c in carry]
    pred = _pred(cond(*bufs))
    with _body(pred, True) as (handle, side):
        captured_launches += 1
        new = list(body(*bufs))
        if len(new) != len(bufs):
            raise ValueError(
                f"while body returned {len(new)} values, expected "
                f"{len(bufs)}")
        # a value that is (a view of) a carry buffer is read before any
        # buffer is written: a body may move one carry slot into another
        held = {b.untyped_storage().data_ptr() for b in bufs}
        new = [n.clone() if n.untyped_storage().data_ptr() in held
               else n for n in new]
        for b, n in zip(bufs, new):
            b.copy_(n)
        nxt = _pred(cond(*bufs))
        _check(_lib().ptc_set_conditional(side.cuda_stream, handle,
                                          nxt.data_ptr()),
               "the WHILE node's condition kernel")
        del new, nxt
    del pred
    return bufs


def plain_while(cond: Callable[..., torch.Tensor],
                body: Callable[..., Sequence[torch.Tensor]],
                carry: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`while_node`'s plain version: the Python loop, the predicate
    read on the host every trip."""
    global plain_calls
    vals = list(carry)
    if vals and vals[0].is_cuda:
        plain_calls += 1
    while bool(cond(*vals)):
        vals = list(body(*vals))
    return vals


# ------------------------------------------------------------ warm-up
_warm_stream: Dict[int, torch.cuda.Stream] = {}


def warm_up(fn: Callable[[], object], device: torch.device) -> None:
    """Run ``fn`` once inside a throwaway relaxed capture: its kernels
    build and its libraries initialise, and nothing runs on the card
    (PyTorch's ``ControlFlowOpWarmupDispatchMode`` warms the branch an
    eager call did not take the same way). Its host side effects do
    happen."""
    s = _warm_stream.get(device.index)
    if s is None:
        s = _warm_stream[device.index] = torch.cuda.Stream(device)
    s.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), torch.cuda.graph(
            torch.cuda.CUDAGraph(), stream=s,
            capture_error_mode="relaxed"):
        fn()
