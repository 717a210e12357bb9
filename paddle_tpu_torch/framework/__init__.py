"""``paddle.framework`` of the port: the subset the ops and the namespace
need (:mod:`.core_api`) and the flags (:mod:`.flags`)."""
from . import core_api, flags
from .flags import get_flags, set_flags
from .core_api import (create_parameter, dtype, finfo, get_default_dtype,
                       iinfo, in_dynamic_mode, is_grad_enabled, is_tensor,
                       set_default_dtype)

__all__ = ["core_api", "flags", "get_flags", "set_flags", "create_parameter", "dtype", "finfo",
           "get_default_dtype", "iinfo", "in_dynamic_mode",
           "is_grad_enabled", "is_tensor", "set_default_dtype"]
