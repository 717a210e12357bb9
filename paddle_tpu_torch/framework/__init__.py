"""``paddle.framework`` of the port: the subset the ops and the namespace
need (:mod:`.core_api`)."""
from . import core_api
from .core_api import (create_parameter, dtype, finfo, get_default_dtype,
                       iinfo, in_dynamic_mode, is_grad_enabled, is_tensor,
                       set_default_dtype)

__all__ = ["core_api", "create_parameter", "dtype", "finfo",
           "get_default_dtype", "iinfo", "in_dynamic_mode",
           "is_grad_enabled", "is_tensor", "set_default_dtype"]
