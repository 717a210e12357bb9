"""dy2static: AST rewrite of Python ``if``/``while``/``for`` on tensor
values (``paddle_tpu/jit/dy2static.py``).

The reference needs ~30 transformer passes (``jit/dy2static/``) because
its static graph has no eager fallback. The JAX package's pass only makes
the *syntax* dispatchable, since ``static.nn`` control flow dispatches at
run time; the port keeps that pass as it is (the AST part below is the
JAX package's, line for line) and changes only the run-time converters:

    if t:  A  else:  B        ->   (vars) = _jst.convert_ifelse(t, fT, fF)
    while t:  body            ->   (vars) = _jst.convert_while(c, b, vars)
    for i in range(n): body   ->   (vars) = _jst.convert_for_range(...)
    a and b   (in a test)     ->   _jst.convert_logical_and(a, lambda: b)

with branch and loop bodies lifted into nested functions returning the
names they assign. A predicate is *traced* when it is a Tensor on the
card while its stream is being captured (a ``StaticFunction``'s capture),
a tensor of a ``torch.export`` trace (``jit.save``, ``onnx.export``), or
one that derives from a placeholder of the static program being
recorded; then the converters call ``static.nn.cond``/``while_loop``,
which become conditional nodes of the CUDA graph (``ops/graph_cond.py``),
``torch.cond``/``torch.while_loop`` nodes of the exported program, or
one node of the static program. Anything else is concrete: the converted
code runs the branch Python would, so the pass keeps the meaning of
control flow on Python values and on concrete tensors (the CPU, a
signature's eager first call). A ``for`` over a range with a traced
bound, and the ``break``/``continue``/``return`` guard flags, compile to
the same WHILE node. The guard flags (:func:`true_`, :func:`false_`) are
0-d bool tensors on the caller's device: the device of the
``StaticFunction`` call that runs the code (:func:`flag_device`), else
the default device.

Not converted, as in the JAX package: escapes under ``try``/``with``,
generators, loop ``else`` clauses, ``for`` with tuple targets,
``break``/``continue`` in non-range ``for`` loops, a ``return`` inside a
traced loop whose value cannot ride the carry (it raises), and anything
whose source is unavailable (lambdas, the REPL): the transform then
returns the function as it is.
"""
from __future__ import annotations

import ast
import contextlib
import copy
import inspect
import textwrap
import types
import warnings
from typing import List, Sequence

import torch

__all__ = ["ast_transform", "convert_ifelse", "convert_while",
           "convert_for_range", "convert_logical_and", "convert_logical_or",
           "convert_logical_not", "UNDEFINED", "ld", "true_", "false_",
           "flag_device"]


class _Undefined:
    """Sentinel for names unbound before a converted branch assigns them
    (the reference's dy2static UndefinedVar)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):  # pragma: no cover
        return "<dy2static.UNDEFINED>"

    def __bool__(self):
        raise NameError(
            "variable is undefined on this control-flow path (assigned in "
            "only one branch of a converted if/while)")


UNDEFINED = _Undefined()


def ld(local_ns: dict, name: str):
    """Load ``name`` from a locals() snapshot, UNDEFINED when unbound."""
    return local_ns.get(name, UNDEFINED)


_flag_devices: List[torch.device] = []


@contextlib.contextmanager
def flag_device(device: torch.device):
    """Make the guard flags of converted code run in the block on
    ``device`` (a ``StaticFunction`` call's)."""
    _flag_devices.append(torch.device(device))
    try:
        yield
    finally:
        _flag_devices.pop()


def _device() -> torch.device:
    if _flag_devices:
        return _flag_devices[-1]
    from ..device import default_device

    return default_device()


def _scalar(value, dtype) -> "Tensor":
    """A new 0-d Tensor on the flags' device (a fill: capturable)."""
    from ..tensor import Tensor

    return Tensor._wrap(torch.full((), value, dtype=dtype,
                                   device=_device()))


def true_():
    """A concrete 0-d bool Tensor: break/continue/return guard flags are
    seeded as tensors (not Python bools) so a traced loop can carry them,
    while the eager regime just reads them."""
    return _scalar(True, torch.bool)


def false_():
    return _scalar(False, torch.bool)


def _flag_set(v) -> bool:
    """Early exit of the unrolled (concrete-bound) regime: True when the
    break flag is readably set. A traced flag returns False: the loop
    keeps unrolling, which stays correct because pass B wraps the whole
    for-body (the target's assignment included) in the ``not brk``
    guard; the iterations after a break become conditional no-ops."""
    if _is_traced_tensor(v):
        return False
    if _is_tensor(v):
        return bool(v)
    return bool(v)


def _is_tensor(x) -> bool:
    from ..tensor import Tensor

    return isinstance(x, Tensor)


def _is_traced_tensor(x) -> bool:
    """A Tensor whose value the host cannot read now: on the card under
    capture, a tensor of a ``torch.export`` trace, or derived from a
    placeholder of the program being recorded."""
    if not _is_tensor(x):
        return False
    from .. import tensor as _tensor
    from ..ops import graph_cond as _gc
    from ..static.nn.control_flow import exporting

    if _gc.capturing(x._value) or exporting(x):
        return True
    rec = _tensor.program_recorder
    return rec is not None and rec.records() and rec.derived(x)


# ------------------------------------------------------------- converters

def convert_ifelse(pred, true_fn, false_fn, args=()):
    """Run-time dispatch of a rewritten ``if`` (the reference's
    convert_operators.py convert_ifelse). ``args`` are the current values
    of the names either branch assigns, passed as parameters so a branch
    that both reads and writes a name does not trip UnboundLocalError."""
    if _is_traced_tensor(pred):
        from ..static.nn import cond as _cond

        return _cond(pred, lambda: true_fn(*args), lambda: false_fn(*args))
    taken = true_fn if (bool(pred.numpy().reshape(())) if _is_tensor(pred)
                        else bool(pred)) else false_fn
    return taken(*args)


def convert_while(cond_fn, body_fn, vals: Sequence):
    """Run-time dispatch of a rewritten ``while``. ``vals`` are the
    candidate loop variables (UNDEFINED for names unbound before the
    loop: per-iteration temporaries). In the traced regime a loop
    variable bound to a Python number joins the carry as a 0-d tensor
    (int32 for an int, the default float type for a float), as the
    for-range header does; the eager regime keeps Python arithmetic."""
    probe = cond_fn(*vals)
    if not _is_traced_tensor(probe):
        # eager regime: the plain Python loop
        vals = list(vals)
        first = probe
        while (bool(first.numpy().reshape(())) if _is_tensor(first)
               else bool(first)):
            vals = list(body_fn(*vals))
            first = cond_fn(*vals)
        return tuple(vals)

    from ..static.nn import while_loop as _while_loop

    vals = list(vals)
    for idx, v in enumerate(vals):
        if isinstance(v, (bool, int, float)):
            dt = (torch.int32 if isinstance(v, int)
                  and not isinstance(v, bool) else
                  torch.bool if isinstance(v, bool)
                  else torch.get_default_dtype())
            vals[idx] = _scalar(v, dt)

    carried = [i for i, v in enumerate(vals) if v is not UNDEFINED]
    if not carried:
        raise ValueError(
            "while on a traced predicate needs at least one loop variable "
            "bound before the loop")

    def merge(cvals):
        full = list(vals)
        for i, v in zip(carried, cvals):
            full[i] = v
        return full

    def cond2(*cvals):
        return cond_fn(*merge(cvals))

    def body2(*cvals):
        out = list(body_fn(*merge(cvals)))
        return [out[i] for i in carried]

    finals = _while_loop(cond2, body2, [vals[i] for i in carried])
    full = [UNDEFINED] * len(vals)  # temporaries are dead after the loop
    for i, v in zip(carried, finals):
        full[i] = v
    return tuple(full)


def convert_for_range(range_args, body_fn, vals: Sequence,
                      tgt_index: int = -1, range_obj=range,
                      brk_index: int = -1):
    """Run-time dispatch of a rewritten ``for <tgt> in range(...)``.

    ``body_fn(hdr, *vals)`` binds the loop target to ``hdr`` as its first
    statement and returns the loop variables. Concrete bounds run the
    plain Python loop (CPython's semantics); a traced bound becomes one
    while loop through :func:`convert_while` with the carry ``(hdr,
    *vals)``. In that regime the header is carried as int32, a
    zero-trip loop leaves the target at ``start`` (a carry cannot be
    unbound), and a traced step raises."""
    import builtins
    import operator

    if range_obj is not builtins.range:
        # the AST match is syntactic: a shadowed `range` keeps Python's
        # semantics, iterating whatever it returns
        vals = list(vals)
        for h in range_obj(*range_args):
            vals = list(body_fn(h, *vals))
            if brk_index >= 0 and _flag_set(vals[brk_index]):
                break
        return tuple(vals)

    args = list(range_args)
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    else:
        start, stop, step = args
    if _is_traced_tensor(step):
        raise NotImplementedError(
            "for-range with a TRACED step is not supported under "
            "to_static — make the step a Python int (or a concrete "
            "tensor); traced start/stop are fine")

    # CPython's validation (a float raises, it does not truncate the trip
    # count), for tensors too; bool stays legal (range(True) is valid)
    def _check_integral(b, what):
        if not _is_tensor(b):
            return operator.index(b)
        dt = b._value.dtype
        if dt.is_floating_point or dt.is_complex:
            from ..dtypes import dtype_name

            raise TypeError(
                f"'{dtype_name(dt)}' tensor cannot be interpreted as an "
                f"integer range {what} (cast explicitly if truncation is "
                "intended)")
        return b

    if _is_tensor(step):
        _check_integral(step, "step")
        step = int(step.numpy().reshape(()))
    else:
        step = operator.index(step)
    if step == 0:
        raise ValueError("range() arg 3 must not be zero")
    for b in (start, stop):
        _check_integral(b, "bound")

    vals = list(vals)
    if not any(_is_traced_tensor(b) for b in (start, stop)):
        # concrete: CPython's semantics, the bounds as Python ints
        s0 = int(start.numpy().reshape(())) if _is_tensor(start) else start
        s1 = int(stop.numpy().reshape(())) if _is_tensor(stop) else stop
        if (brk_index >= 0 and 0 <= tgt_index < len(vals)
                and vals[tgt_index] is UNDEFINED):
            # a lifted break puts the target inside the guard if; when the
            # flag is traced that if is a conditional node, whose merge
            # needs a defined value on the other path
            vals[tgt_index] = s0
        for h in range(s0, s1, step):
            vals = list(body_fn(h, *vals))
            if brk_index >= 0 and _flag_set(vals[brk_index]):
                break
        return tuple(vals)

    # a bound is traced: one while loop, whose carry holds tensors only;
    # the header is int32 whatever the bound's type (an int64 header would
    # promote int32 accumulators the target touches)
    if not _is_tensor(start):
        start = _scalar(start, torch.int32)
    elif start._value.dtype != torch.int32:
        start = start.astype("int32")
    # the target rides the carry even when unbound before the loop; a
    # distinct tensor, since one object in two carry slots confuses the
    # slot bookkeeping
    if 0 <= tgt_index < len(vals) and vals[tgt_index] is UNDEFINED:
        vals[tgt_index] = start.clone()

    if step > 0:
        def cond_hdr(h):
            return h < stop
    else:
        def cond_hdr(h):
            return h > stop

    if brk_index >= 0:
        def cond_fn(h, *vs):
            # the break flag rides the carry: loop while in range and the
            # body has not raised it (the reference's
            # break_continue_transformer.py:88 folds it in the same way)
            from ..ops import logic as _logic
            return _logic.logical_and(cond_hdr(h),
                                      _logic.logical_not(vs[brk_index]))
    else:
        def cond_fn(h, *vs):
            return cond_hdr(h)

    def body2(h, *vs):
        out = body_fn(h, *vs)
        return (h + step, *out)

    res = convert_while(cond_fn, body2, (start, *vals))
    return res[1:]


def _concrete_scalar_bool(x):
    """bool(x) when x is a concrete one-element tensor, else None: the
    logical converters keep CPython's short circuit in the eager regime
    (``not brk and arr[i] > 0`` must skip the read after a break)."""
    if (_is_tensor(x) and not _is_traced_tensor(x)
            and x._value.numel() == 1):
        return bool(x)
    return None


def convert_for_iter(iterable, body_fn, vals: Sequence):
    """Run-time dispatch of a rewritten ``for <name> in <expr>`` over
    anything but a range call. A Tensor iterates its first axis (a static
    trip count: the loop unrolls over ``it[i]``); anything else runs
    Python's iteration protocol. The body runs in a frame of its own each
    iteration, so a closure over the loop variable sees that iteration's
    value, not CPython's one shared cell."""
    vals = list(vals)
    if _is_tensor(iterable):
        if not len(iterable.shape):
            raise TypeError("iteration over a 0-d Tensor")
        for i in range(int(iterable.shape[0])):
            vals = list(body_fn(iterable[i], *vals))
        return tuple(vals)
    for h in iterable:
        vals = list(body_fn(h, *vals))
    return tuple(vals)


def convert_logical_and(x, y_fn):
    """``a and b``, short-circuited for Python values and concrete scalar
    tensors (the reference's convert_logical_and); a traced or array
    operand is the elementwise op (both sides evaluate)."""
    if _is_tensor(x):
        xb = _concrete_scalar_bool(x)
        if xb is not None:
            return y_fn() if xb else x
        from ..ops import logic as _logic

        return _logic.logical_and(x, y_fn())
    return x and y_fn()


def convert_logical_or(x, y_fn):
    if _is_tensor(x):
        xb = _concrete_scalar_bool(x)
        if xb is not None:
            return x if xb else y_fn()
        from ..ops import logic as _logic

        return _logic.logical_or(x, y_fn())
    return x or y_fn()


def convert_logical_not(x):
    if _is_tensor(x):
        from ..ops import logic as _logic

        return _logic.logical_not(x)
    return not x


_JST = "__paddle_jst__"


# ----------------------------------------------------------- AST analysis

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef, ast.ListComp, ast.SetComp, ast.DictComp,
                ast.GeneratorExp)


def _assigned_names(nodes: Sequence[ast.stmt]) -> List[str]:
    """Plain Names stored at this function's scope within ``nodes``.
    Generated locals()-snapshot temps are excluded: they are dicts
    assigned+consumed within one statement run and must never become
    branch targets or loop carries (a dict leaf poisons a compiled
    carry; an UNDEFINED one poisons a traced branch merge)."""
    out = []

    def walk(n):
        if isinstance(n, _SCOPE_NODES):
            return
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            if (n.id not in out
                    and not n.id.startswith(("__jst_locals_",
                                             "__jst_rloc_"))):
                out.append(n.id)
        for c in ast.iter_child_nodes(n):
            walk(c)

    for n in nodes:
        walk(n)
    return out


def _has_flow_escape(nodes: Sequence[ast.stmt]) -> bool:
    """break/continue/return/yield at this scope inside ``nodes``."""
    found = False

    def walk(n):
        nonlocal found
        if found or isinstance(n, _SCOPE_NODES):
            return
        if isinstance(n, (ast.Break, ast.Continue, ast.Return, ast.Yield,
                          ast.YieldFrom)):
            found = True
            return
        for c in ast.iter_child_nodes(n):
            walk(c)

    for n in nodes:
        walk(n)
    return found


def _escapes_at_level(nodes: Sequence[ast.stmt], *, into_loops: bool):
    """Which flow escapes occur at this level: a set of
    {'break','continue','return','yield','try'}. break/continue bind to
    the nearest LOOP, so the walk never descends into nested loops for
    them; return/yield escape the FUNCTION, so with ``into_loops=True``
    the walk descends into loops too (but never nested scopes). A 'try'
    marker is reported when an escape sits inside a Try at this level —
    guard-wrapping across exception scopes is not attempted."""
    found = set()

    def walk(n, in_try):
        if isinstance(n, _SCOPE_NODES):
            return
        if isinstance(n, ast.Break):
            found.add("try" if in_try else "break")
            return
        if isinstance(n, ast.Continue):
            found.add("try" if in_try else "continue")
            return
        if isinstance(n, ast.Return):
            found.add("try" if in_try else "return")
            return
        if isinstance(n, (ast.Yield, ast.YieldFrom)):
            found.add("yield")
            return
        if isinstance(n, (ast.While, ast.For, ast.AsyncFor)):
            if into_loops:
                for c in ast.iter_child_nodes(n):
                    walk(c, in_try)
            return
        in_try = in_try or isinstance(n, (ast.Try,))
        for c in ast.iter_child_nodes(n):
            walk(c, in_try)

    for n in nodes:
        walk(n, False)
    return found


class _Bail(Exception):
    """Internal: abort a rewrite pass, leaving the function as-is."""


def _assign(name: str, value: ast.expr) -> ast.Assign:
    return ast.Assign(targets=[_name(name, ast.Store())], value=value)


def _locals_snapshot_stmts(uid_fn, names, tag: str):
    """stmts binding each unbound name to UNDEFINED via ONE locals() read
    — shared by every pass that lifts names into generated functions.
    The snapshot temp's name must stay on _assigned_names' exclusion list."""
    snap = uid_fn(tag)
    stmts = [_assign(snap, ast.Call(func=_name("locals"), args=[],
                                    keywords=[]))]
    for n in names:
        stmts.append(_assign(n, _jst_call(
            "ld", [_name(snap), ast.Constant(value=n)])))
    return stmts


def _fn_def(fname, argnames, body, ret_names=None):
    """A generated nested function. ``ret_names`` appends a tuple-return
    of those names; None leaves the body's own returns in charge (a CPS
    branch falling off the end returns None, like CPython)."""
    body = list(body) or [ast.Pass()]
    if ret_names is not None:
        body = body + [ast.Return(value=ast.Tuple(
            elts=[_name(n) for n in ret_names], ctx=ast.Load()))]
    return ast.FunctionDef(
        name=fname,
        args=ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=a) for a in argnames],
            kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=body, decorator_list=[])


def _all_paths_return(stmts: Sequence[ast.stmt]) -> bool:
    """Conservative: True when every path through ``stmts`` ends in a
    Return (chains of if/else with returning branches count; raise and
    infinite loops deliberately don't)."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Return):
        return True
    if isinstance(last, ast.If):
        return (bool(last.orelse) and _all_paths_return(last.body)
                and _all_paths_return(last.orelse))
    return False


class _ReturnRewriter:
    """Pass R (reference: return_transformer.py): rewrite early/nested
    ``return`` so the remaining control flow is convertible.

    - ``if`` containing returns → CPS: the if becomes
      ``return convert_ifelse(t, fT, fF)`` where each branch function ends
      the function (the statements AFTER the if — the continuation — are
      folded into the branch(es) that fall through). Under a traced
      predicate both branches must produce the same return structure
      (loud _traced_multiway error otherwise); concrete predicates keep
      exact CPython semantics.
    - a loop containing returns → guard-carry: ``return e`` becomes
      retval/flag assignments + ``break`` (pass B then converts the
      break), and the loop is followed by
      ``return convert_ifelse(flag, lambda: retval, rest_fn)``.
      Compiled (tensor-predicate) loops reject this shape loudly today —
      the retval cannot be carried without a pre-seeded structure; the
      eager regime is exact.
    Raises _Bail for shapes it won't touch (returns under Try/With,
    generators) — the function then keeps its previous behavior.
    """

    _NODE_BUDGET = 20_000  # CPS duplicates continuations; cap the blowup

    def __init__(self, uid_fn):
        self._next = uid_fn
        self._rv = self._next("rv")
        self._rf = self._next("rf")
        self._nodes = 0
        self.changed = False

    # -- helpers -------------------------------------------------------
    def _charge(self, stmts):
        self._nodes += sum(len(list(ast.walk(s))) for s in stmts)
        if self._nodes > self._NODE_BUDGET:
            raise _Bail("return-CPS continuation duplication too large")

    def _may_return(self, st) -> bool:
        esc = _escapes_at_level([st], into_loops=True)
        if "yield" in esc:
            raise _Bail("yield")
        if "try" in esc:
            raise _Bail("return under try")
        return "return" in esc

    def _branch_fn(self, fname, argnames, body):
        return _fn_def(fname, argnames, body)

    def _locals_snapshot(self, names):
        return _locals_snapshot_stmts(self._next, names, "rloc")

    def _cps_if(self, node: ast.If, rest: List[ast.stmt]) -> List[ast.stmt]:
        """(if + continuation) → single Return of convert_ifelse."""
        self.changed = True
        t_apr = _all_paths_return(node.body)
        f_apr = _all_paths_return(node.orelse) if node.orelse else False
        t_body = list(node.body) + ([] if t_apr
                                    else [copy.deepcopy(s) for s in rest])
        f_body = list(node.orelse) + ([] if f_apr else list(rest))
        if not (t_apr and f_apr):
            self._charge(rest)
        t_body = self.transform_block(t_body)
        f_body = self.transform_block(f_body)
        targets = list(dict.fromkeys(
            _assigned_names(t_body) + _assigned_names(f_body)))
        tname, fname = self._next("retT"), self._next("retF")
        out = self._locals_snapshot(targets)
        out.append(self._branch_fn(tname, targets, t_body))
        out.append(self._branch_fn(fname, targets, f_body))
        out.append(ast.Return(value=_jst_call(
            "convert_ifelse",
            [_TestTransformer().visit(node.test), _name(tname),
             _name(fname),
             ast.Tuple(elts=[_name(n) for n in targets], ctx=ast.Load())])))
        return out

    def _rewrite_loop_returns(self, stmts: List[ast.stmt]) -> List[ast.stmt]:
        """Inside a loop body: return e → rv/rf set + break; statements
        after the return in the same block are dropped (unreachable).
        Nested loops were already processed bottom-up, so a remaining
        Return at this walk belongs to the enclosing function."""
        out = []
        for st in stmts:
            if isinstance(st, ast.Return):
                out.append(_assign(self._rv,
                                   st.value if st.value is not None
                                   else ast.Constant(value=None)))
                out.append(_assign(self._rf, _jst_call("true_", [])))
                out.append(ast.Break())
                break
            if isinstance(st, ast.If):
                st = ast.If(test=st.test,
                            body=self._rewrite_loop_returns(list(st.body)),
                            orelse=self._rewrite_loop_returns(
                                list(st.orelse)))
            elif isinstance(st, ast.With):
                st = ast.With(items=st.items,
                              body=self._rewrite_loop_returns(list(st.body)))
            elif isinstance(st, (ast.While, ast.For)):
                st = self._process_loop(st, inner=True)
                if isinstance(st, list):
                    out.extend(st)
                    continue
            elif self._may_return(st):
                raise _Bail(f"return inside {type(st).__name__}")
            out.append(st)
        return out

    def _process_loop(self, node, *, inner: bool):
        """Rewrite returns within one loop. ``inner=True``: a loop nested
        inside another return-carrying loop — after it, propagate the
        flag outward with ``if rf: break`` (pass B converts that break at
        the enclosing level)."""
        if not self._may_return(node):
            return node
        if node.orelse:
            raise _Bail("return in a loop with an else clause")
        body = self._rewrite_loop_returns(list(node.body))
        new = (ast.While(test=node.test, body=body, orelse=[])
               if isinstance(node, ast.While) else
               ast.For(target=node.target, iter=node.iter, body=body,
                       orelse=[]))
        if not inner:
            return new
        # propagation: the enclosing loop must also stop
        return [new, ast.If(test=_name(self._rf),
                            body=[ast.Break()], orelse=[])]

    def transform_block(self, stmts: List[ast.stmt]) -> List[ast.stmt]:
        out = []
        for i, st in enumerate(stmts):
            rest = stmts[i + 1:]
            if isinstance(st, ast.Return):
                out.append(st)      # block-terminal return: fine as-is
                return out          # anything after is unreachable
            if not self._may_return(st):
                out.append(st)
                continue
            if isinstance(st, ast.If):
                out.extend(self._cps_if(st, rest))
                return out
            if isinstance(st, (ast.While, ast.For)):
                processed = self._process_loop(st, inner=False)
                loop_stmts = (processed if isinstance(processed, list)
                              else [processed])
                # init the flag BEFORE the loop so it is a carried loop var
                out.append(_assign(self._rf, _jst_call("false_", [])))
                out.extend(loop_stmts)
                rest_t = self.transform_block(list(rest))
                targets = list(dict.fromkeys(_assigned_names(rest_t)))
                vname, rname = self._next("retV"), self._next("retRest")
                out.extend(self._locals_snapshot(targets))
                out.append(self._branch_fn(
                    vname, targets, [ast.Return(value=_name(self._rv))]))
                out.append(self._branch_fn(rname, targets, rest_t))
                out.append(ast.Return(value=_jst_call(
                    "convert_ifelse",
                    [_name(self._rf), _name(vname), _name(rname),
                     ast.Tuple(elts=[_name(n) for n in targets],
                               ctx=ast.Load())])))
                return out
            raise _Bail(f"return inside {type(st).__name__}")
        return out


class _BreakContinueRewriter(ast.NodeTransformer):
    """Pass B (reference: break_continue_transformer.py:88): lift
    ``break``/``continue`` in convertible loops into boolean guard-carry
    flags so the loop itself becomes convertible.

    - break    → ``__jst_brk_N = true_()`` (+ the loop condition gains
                 ``and not __jst_brk_N``; for-range loops get the flag's
                 carry index plumbed through ``brk_index``)
    - continue → ``__jst_cnt_N = true_()`` (reset at iteration start)
    - statements AFTER a possibly-escaping statement are wrapped in
      ``if not (flag or ...):`` guards, which the main transformer then
      converts like any other if.
    Flags are concrete bool TENSORS (true_/false_) so compiled loops can
    carry them. Loops the main pass would not convert (for over
    non-range, loop-else, escapes under Try, yields) are left alone.
    """

    def __init__(self, uid_fn):
        self._next = uid_fn
        self.changed = False

    # -- analysis ------------------------------------------------------
    @staticmethod
    def _loop_escapes(body):
        return _escapes_at_level(body, into_loops=False)

    @staticmethod
    def _for_is_convertible(node) -> bool:
        """INTENTIONALLY range-only — narrower than visit_For, which
        also converts non-range iterables. Break-lifting needs a loop
        condition to fold the flag into; a non-range for has none
        (convert_for_iter has no brk_index), so marking one here would
        produce exactly the half-rewritten NameError _rewrite_loop's
        all-or-nothing gate guards against. Do not 'sync' this with
        visit_For's wider gate."""
        return (not node.orelse
                and isinstance(node.target, ast.Name)
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"
                and not node.iter.keywords
                and not any(isinstance(a, ast.Starred)
                            for a in node.iter.args))

    # -- rewrite -------------------------------------------------------
    def _guard(self, flags: List[str], body: List[ast.stmt]) -> ast.If:
        test: ast.expr = _name(flags[0])
        for f in flags[1:]:
            test = ast.BoolOp(op=ast.Or(),
                              values=[test, _name(f)])
        return ast.If(test=ast.UnaryOp(op=ast.Not(), operand=test),
                      body=body, orelse=[])

    def _rewrite_block(self, stmts, brk, cnt):
        """Replace break/continue with flag sets; wrap trailing statements
        of a block in a not-escaped guard. Recurses into if/with blocks
        (break/continue cannot escape a nested loop)."""
        out = []
        for i, st in enumerate(stmts):
            if isinstance(st, ast.Break):
                out.append(_assign(brk, _jst_call("true_", [])))
                return out, {"break"}
            if isinstance(st, ast.Continue):
                out.append(_assign(cnt, _jst_call("true_", [])))
                return out, {"continue"}
            escapes = set()
            if isinstance(st, ast.If):
                b, eb = self._rewrite_block(list(st.body), brk, cnt)
                o, eo = self._rewrite_block(list(st.orelse), brk, cnt)
                st = ast.If(test=st.test, body=b, orelse=o)
                escapes = eb | eo
            elif isinstance(st, ast.With):
                b, escapes = self._rewrite_block(list(st.body), brk, cnt)
                st = ast.With(items=st.items, body=b)
            out.append(st)
            if escapes and i + 1 < len(stmts):
                rest, er = self._rewrite_block(stmts[i + 1:], brk, cnt)
                flags = [f for f, e in ((brk, "break"), (cnt, "continue"))
                         if e in escapes]
                out.append(self._guard(flags, rest))
                return out, escapes | er
            if escapes:
                return out, escapes
        return out, set()

    def _rewrite_loop(self, node):
        escapes = self._loop_escapes(node.body)
        if not escapes & {"break", "continue"}:
            return node
        if escapes - {"break", "continue"}:
            # an unhandled escape (return pass R bailed on, yield, try)
            # would leave the loop unconvertible downstream — rewriting
            # only break/continue would then STRIP the for-range's break
            # semantics (the plain-Python fallback loop has no flag
            # check). All-or-nothing: leave the loop alone.
            return node
        brk, cnt = self._next("brk"), self._next("cnt")
        body, _ = self._rewrite_block(list(node.body), brk, cnt)
        if _has_flow_escape(body):
            # escapes remain that the downstream converter will refuse —
            # e.g. a nested NON-convertible loop keeping its own literal
            # break (for-over-list), or a return pass R bailed on. The
            # main pass would then leave the loop plain Python, and a
            # half-rewritten for-range would reference a header name that
            # is never defined (r5 review repro: NameError). Gate must
            # match visit_For/_While exactly: all-or-nothing.
            return node
        self.changed = True
        pre = []
        if "continue" in escapes:
            body = [_assign(cnt, _jst_call("false_", []))] + body
        if "break" in escapes:
            pre = [_assign(brk, _jst_call("false_", []))]
            if isinstance(node, ast.While):
                # flag FIRST: `not brk and test` — after a break CPython
                # never re-evaluates the test, and the converters
                # short-circuit concrete scalar flags, so a raising/
                # side-effecting test (arr[i] after i walked off the end)
                # is skipped exactly like CPython skips it
                node = ast.While(
                    test=ast.BoolOp(op=ast.And(), values=[
                        ast.UnaryOp(op=ast.Not(), operand=_name(brk)),
                        node.test]),
                    body=body, orelse=[])
            else:
                # a for-range has no condition slot, so the WHOLE body is
                # guarded: once the flag is up every further iteration is
                # a no-op. This keeps the unrolled regime correct even
                # when the flag is a tracer (under jit every constant is)
                # — _flag_set's early exit is just an optimization. The
                # compiled regime additionally stops via brk_index in the
                # loop condition (convert_for_range).
                body = [ast.If(
                    test=ast.UnaryOp(op=ast.Not(), operand=_name(brk)),
                    body=body, orelse=[])]
                node = ast.For(target=node.target, iter=node.iter,
                               body=body, orelse=[])
                node._jst_brk_name = brk
        else:
            node = (ast.While(test=node.test, body=body, orelse=[])
                    if isinstance(node, ast.While) else
                    ast.For(target=node.target, iter=node.iter, body=body,
                            orelse=[]))
        return pre + [node] if pre else node

    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse:
            return node
        return self._rewrite_loop(node)

    def visit_For(self, node):
        self.generic_visit(node)
        if not self._for_is_convertible(node):
            return node
        return self._rewrite_loop(node)


def _jst_call(attr: str, args: List[ast.expr]) -> ast.Call:
    return ast.Call(
        func=ast.Attribute(value=ast.Name(id=_JST, ctx=ast.Load()),
                           attr=attr, ctx=ast.Load()),
        args=args, keywords=[])


def _name(n, ctx=None):
    return ast.Name(id=n, ctx=ctx or ast.Load())


class _TestTransformer(ast.NodeTransformer):
    """Rewrites and/or/not inside a converted test expression so tensor
    operands don't hit Tracer.__bool__ (reference: logical_transformer.py)."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = "convert_logical_and" if isinstance(node.op, ast.And) \
            else "convert_logical_or"
        expr = node.values[-1]
        for prev in reversed(node.values[:-1]):
            expr = _jst_call(fn, [prev, ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[]),
                body=expr)])
        return expr

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return _jst_call("convert_logical_not", [node.operand])
        return node


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self.changed = False
        self._uid = 0

    def _next(self, tag):
        self._uid += 1
        return f"__jst_{tag}_{self._uid}"

    def _locals_snapshot(self, names):
        return _locals_snapshot_stmts(self._next, names, "locals")

    def _make_fn(self, fname, argnames, body, ret_names):
        return _fn_def(fname, argnames, body, ret_names)

    # ------------------------------------------------------------------ if
    def visit_If(self, node):
        self.generic_visit(node)
        test = _TestTransformer().visit(node.test)
        # common early-return shape: both branches are a single `return e`
        if (len(node.body) == 1 and isinstance(node.body[0], ast.Return)
                and node.body[0].value is not None
                and len(node.orelse) == 1
                and isinstance(node.orelse[0], ast.Return)
                and node.orelse[0].value is not None):
            self.changed = True
            lam = lambda e: ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[]),
                body=e)
            return ast.Return(value=_jst_call(
                "convert_ifelse",
                [test, lam(node.body[0].value), lam(node.orelse[0].value)]))
        if _has_flow_escape(node.body) or _has_flow_escape(node.orelse):
            return node  # leave plain Python (concrete predicates only)
        targets = _assigned_names(node.body + node.orelse)
        self.changed = True
        tname, fname = self._next("true"), self._next("false")
        stmts = self._locals_snapshot(targets)
        stmts.append(self._make_fn(tname, targets, node.body or [ast.Pass()],
                                   targets))
        stmts.append(self._make_fn(fname, targets,
                                   node.orelse or [ast.Pass()], targets))
        call = _jst_call("convert_ifelse",
                         [test, _name(tname), _name(fname),
                          ast.Tuple(elts=[_name(n) for n in targets],
                                    ctx=ast.Load())])
        if targets:
            stmts.append(ast.Assign(
                targets=[ast.Tuple(elts=[_name(n, ast.Store())
                                         for n in targets],
                                   ctx=ast.Store())],
                value=call))
        else:
            stmts.append(ast.Expr(value=call))
        return stmts

    # ----------------------------------------------------------------- for
    def visit_For(self, node):
        """``for <name> in range(...)`` → convert_for_range: a TENSOR
        range bound becomes one while loop (a WHILE node under capture). Concrete bounds keep the unroll (dispatched at runtime).
        Anything else — non-range iterables, tuple targets, break/
        continue/return, for-else — stays plain Python."""
        # pass B wrapped a breaking loop's WHOLE body in `if not brk:`;
        # the loop target must be assigned INSIDE that guard (broken-out
        # unrolled iterations must not keep advancing it past CPython's
        # value) — insert BEFORE generic_visit converts the guard if.
        # pass B only marks shapes that pass every gate below, so the
        # conversion is guaranteed to proceed once the marker exists.
        brk_name = getattr(node, "_jst_brk_name", None)
        hdr = None
        if brk_name:
            hdr = self._next("hdr")
            guard = node.body[-1]
            assert isinstance(guard, ast.If), "pass B guard invariant"
            guard.body.insert(0, ast.Assign(
                targets=[_name(node.target.id, ast.Store())],
                value=_name(hdr)))
        self.generic_visit(node)
        if (node.orelse or _has_flow_escape(node.body)
                or not isinstance(node.target, ast.Name)):
            return node
        if not (isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"
                and not node.iter.keywords
                and not any(isinstance(a, ast.Starred)
                            for a in node.iter.args)):
            # non-range iterable → convert_for_iter: a TENSOR iterates
            # its first axis (a static trip count); plain
            # iterables keep the exact Python protocol at runtime
            tgt = node.target.id
            loop_vars = list(dict.fromkeys(
                _assigned_names(node.body) + [tgt]))
            self.changed = True
            bname = self._next("foriter")
            ihdr = self._next("hdr")
            stmts = self._locals_snapshot(loop_vars)
            body = [ast.Assign(targets=[_name(tgt, ast.Store())],
                               value=_name(ihdr))] + list(node.body)
            stmts.append(self._make_fn(bname, [ihdr] + loop_vars, body,
                                       loop_vars))
            stmts.append(ast.Assign(
                targets=[ast.Tuple(elts=[_name(n, ast.Store())
                                         for n in loop_vars],
                                   ctx=ast.Store())],
                value=_jst_call("convert_for_iter", [
                    node.iter, _name(bname),
                    ast.Tuple(elts=[_name(n) for n in loop_vars],
                              ctx=ast.Load())])))
            return stmts
        tgt = node.target.id
        loop_vars = list(dict.fromkeys(_assigned_names(node.body) + [tgt]))
        self.changed = True
        bname = self._next("forbody")
        # the flag's slot index rides to the runtime so both the unrolled
        # and the compiled regime stop on the lifted break
        brk_index = loop_vars.index(brk_name) if brk_name else -1
        stmts = self._locals_snapshot(loop_vars)
        if hdr is None:
            hdr = self._next("hdr")
            body = [ast.Assign(targets=[_name(tgt, ast.Store())],
                               value=_name(hdr))] + list(node.body)
        else:
            body = list(node.body)  # target assign already in the guard
        stmts.append(self._make_fn(bname, [hdr] + loop_vars, body,
                                   loop_vars))
        call = _jst_call("convert_for_range", [
            ast.Tuple(elts=list(node.iter.args), ctx=ast.Load()),
            _name(bname),
            ast.Tuple(elts=[_name(n) for n in loop_vars], ctx=ast.Load()),
            ast.Constant(value=loop_vars.index(tgt)),
            # `range` resolved in the FUNCTION's scope at runtime: a
            # shadowed range falls back to the plain-Python loop inside
            # convert_for_range instead of being silently hijacked
            _name("range"),
            ast.Constant(value=brk_index)])
        stmts.append(ast.Assign(
            targets=[ast.Tuple(elts=[_name(n, ast.Store())
                                     for n in loop_vars],
                               ctx=ast.Store())],
            value=call))
        return stmts

    # --------------------------------------------------------------- while
    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _has_flow_escape(node.body):
            return node
        test = _TestTransformer().visit(node.test)
        loop_vars = _assigned_names(node.body)
        if not loop_vars:
            return node
        self.changed = True
        cname, bname = self._next("cond"), self._next("body")
        stmts = self._locals_snapshot(loop_vars)
        stmts.append(self._make_fn(
            cname, loop_vars,
            [ast.Return(value=test)], []))
        # cond returns the test, not a tuple — fix the trailing return
        stmts[-1].body = [ast.Return(value=test)]
        stmts.append(self._make_fn(bname, loop_vars, node.body, loop_vars))
        call = _jst_call("convert_while", [
            _name(cname), _name(bname),
            ast.Tuple(elts=[_name(n) for n in loop_vars], ctx=ast.Load())])
        stmts.append(ast.Assign(
            targets=[ast.Tuple(elts=[_name(n, ast.Store())
                                     for n in loop_vars],
                               ctx=ast.Store())],
            value=call))
        return stmts


# ------------------------------------------------------------- entry point

def ast_transform(fn):
    """Return ``fn`` rewritten for tensor control flow, or ``fn`` unchanged
    when nothing needs rewriting or the source is unavailable."""
    bound_self = None
    if inspect.ismethod(fn):
        bound_self = fn.__self__
        fn = fn.__func__
    if not isinstance(fn, types.FunctionType):
        return fn if bound_self is None else fn.__get__(bound_self)
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn if bound_self is None else fn.__get__(bound_self)
    if not tree.body or not isinstance(tree.body[0],
                                       (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
        return fn if bound_self is None else fn.__get__(bound_self)

    fdef = tree.body[0]
    fdef.decorator_list = []
    pre_changed = False
    # pass R: single-exit return rewrite (reference return_transformer) —
    # best-effort: a _Bail (returns under try, generators, CPS blowup)
    # keeps the function's previous behavior
    uid_counter = [0]

    def _uid(tag):
        uid_counter[0] += 1
        return f"__jst_{tag}_{uid_counter[0]}"

    tr = _ControlFlowTransformer()
    try:
        try:
            rr = _ReturnRewriter(_uid)
            new_body = rr.transform_block(copy.deepcopy(fdef.body))
            if rr.changed:
                fdef.body = new_body
                pre_changed = True
        except _Bail:
            pass
        # pass B: break/continue → guard-carry flags (reference
        # break_continue_transformer); makes the loops convertible below
        bc = _BreakContinueRewriter(_uid)
        tree = bc.visit(tree)
        pre_changed = pre_changed or bc.changed

        tree = tr.visit(tree)
        if not (tr.changed or pre_changed):
            return fn if bound_self is None else fn.__get__(bound_self)
        ast.fix_missing_locations(tree)

        from . import dy2static as _jst_mod

        # exec against the LIVE module globals (not a snapshot): late-bound
        # helpers, monkeypatching, and self-recursion must keep working.
        # _JST is a reserved dunder, injected once.
        glb = fn.__globals__
        glb[_JST] = _jst_mod

        free = fn.__code__.co_freevars
        if free:
            factory = ast.parse(
                f"def __jst_factory__({', '.join(free)}):\n pass").body[0]
            factory.body = [tree.body[0],
                            ast.Return(value=_name(fdef.name))]
            mod = ast.Module(body=[factory], type_ignores=[])
            ast.fix_missing_locations(mod)
            ns = {}
            exec(compile(mod, f"<dy2static:{fn.__name__}>", "exec"), glb, ns)
            cells = [c.cell_contents for c in fn.__closure__]
            new_fn = ns["__jst_factory__"](*cells)
        else:
            ns = {}
            exec(compile(tree, f"<dy2static:{fn.__name__}>", "exec"), glb, ns)
            new_fn = ns[fdef.name]
    except Exception as e:  # pragma: no cover — conservative fallback
        warnings.warn(f"dy2static transform of {fn.__qualname__} failed "
                      f"({type(e).__name__}: {e}); running untransformed",
                      stacklevel=2)
        return fn if bound_self is None else fn.__get__(bound_self)

    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    new_fn.__qualname__ = fn.__qualname__
    new_fn.__doc__ = fn.__doc__
    new_fn.__dy2static_original__ = fn
    if bound_self is not None:
        return new_fn.__get__(bound_self)
    return new_fn
