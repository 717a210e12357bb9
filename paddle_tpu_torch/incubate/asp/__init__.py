"""``paddle.incubate.asp`` of the port (``paddle_tpu/incubate/asp``):
automatic n:m structured sparsity -- the masks (:mod:`.utils`) and the
prune-and-keep workflow (:mod:`.asp`)."""
from .asp import (  # noqa: F401
    ASPHelper,
    add_supported_layer,
    decorate,
    prune_model,
    reset_excluded_layers,
    set_excluded_layers,
)
from .utils import (  # noqa: F401
    calculate_density,
    check_mask_1d,
    check_mask_2d,
    check_sparsity,
    create_mask,
    get_mask_1d,
    get_mask_2d_best,
    get_mask_2d_greedy,
)

__all__ = [
    "calculate_density", "check_mask_1d", "get_mask_1d", "check_mask_2d",
    "get_mask_2d_greedy", "get_mask_2d_best", "create_mask",
    "check_sparsity", "decorate", "prune_model", "set_excluded_layers",
    "add_supported_layer",
    "reset_excluded_layers", "ASPHelper",
]
