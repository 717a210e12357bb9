"""``paddle.jit`` of the port (``paddle_tpu/jit/__init__.py``): ``to_static``
and ``StaticFunction`` capture an imperative step as one CUDA graph per
input signature (:mod:`.static_function`), with ``InputSpec``,
``not_to_static``, ``enable_to_static``, ``ignore_module``,
``set_code_level``, ``set_verbosity`` and the compile-cache functions.

``BucketedFunction`` (:mod:`.bucketing`) pads dynamic dims onto bucket
ladders first, so a stream of shapes captures one graph per bucket.

``save``, ``load`` and ``TranslatedLayer`` (:mod:`.save_load`) write and
read the deployment artifact on ``torch.export``. The ``dy2static`` AST
pass (:mod:`.dy2static`) rewrites Python control flow on tensor values
for ``to_static``; ``save`` does not export such a forward yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..nn.layer_base import Layer
from .bucketing import (BucketedFunction, bucket_for, pad_to_bucket,
                        pow2_buckets)
from .static_function import (InputSpec, StaticFunction, clear_compile_cache,
                              get_compile_cache_dir, set_compile_cache_dir)
from .save_load import TranslatedLayer, load, save

__all__ = ["to_static", "not_to_static", "save", "load", "TranslatedLayer",
           "StaticFunction", "InputSpec",
           "enable_to_static", "ignore_module", "set_code_level",
           "set_verbosity", "BucketedFunction", "bucket_for",
           "pad_to_bucket", "pow2_buckets", "set_compile_cache_dir",
           "get_compile_cache_dir", "clear_compile_cache"]

_to_static_enabled = True


def enable_to_static(flag: bool) -> None:
    """``paddle.jit.enable_to_static``: with False, :func:`to_static`
    returns what it is given, so the same code runs eagerly."""
    global _to_static_enabled
    _to_static_enabled = bool(flag)


def ignore_module(modules) -> None:
    """``paddle.jit.ignore_module``: nothing to ignore (there is no AST
    pass)."""
    return None


def not_to_static(function: Callable) -> Callable:
    """``paddle.jit.not_to_static``: an annotation only; a capture runs
    everything the function calls."""
    function._paddle_tpu_not_to_static = True
    return function


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Capture a function, or a module's or facade Layer's ``forward``
    (observing it), per input signature (``paddle.jit.to_static``); usable as
    ``@to_static`` or ``to_static(fn, ...)``. ``warmup=`` is passed on
    to :class:`StaticFunction`."""
    warmup = kwargs.pop("warmup", True)

    def decorate(obj):
        if not _to_static_enabled:
            return obj
        if isinstance(obj, (torch.nn.Module, Layer)):
            obj.forward = StaticFunction(obj.forward, input_spec,
                                         observe=[obj], warmup=warmup)
            return obj
        return StaticFunction(obj, input_spec, warmup=warmup)

    if function is None:
        return decorate
    return decorate(function)


_sot_config = {"code_level": 0, "verbosity": 0}


def set_code_level(level: int = 100, also_to_stdout: bool = False) -> None:
    """Recorded for the API (there is no generated code to dump)."""
    _sot_config["code_level"] = int(level)


def set_verbosity(level: int = 0, also_to_stdout: bool = False) -> None:
    """Recorded for the API."""
    _sot_config["verbosity"] = int(level)
