"""``paddle.framework`` of the port: the subset the ops and the namespace
need (:mod:`.core_api`), the flags (:mod:`.flags`) and ``save``/``load``
(:mod:`.io`)."""
from . import core_api, flags
from .flags import get_flags, set_flags
from .core_api import (create_parameter, dtype, finfo, get_default_dtype,
                       iinfo, in_dynamic_mode, is_grad_enabled, is_tensor,
                       set_default_dtype)

def save(obj, path, protocol: int = 4, **configs):
    """``paddle.framework.save``: :func:`.io.save`."""
    from .io import save as _save

    return _save(obj, path, protocol, **configs)


def load(path, device=None, **configs):
    """``paddle.framework.load``: :func:`.io.load`."""
    from .io import load as _load

    return _load(path, device=device, **configs)


__all__ = ["core_api", "flags", "save", "load", "get_flags", "set_flags", "create_parameter", "dtype", "finfo",
           "get_default_dtype", "iinfo", "in_dynamic_mode",
           "is_grad_enabled", "is_tensor", "set_default_dtype"]
