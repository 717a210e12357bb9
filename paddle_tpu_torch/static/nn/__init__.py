"""``paddle.static.nn`` (``paddle_tpu/static/nn/__init__.py``): the
static-graph layers and data-dependent control flow, with the reference's
``__all__`` (``python/paddle/static/nn/__init__.py:63``). Layers make
their own Parameters at build time (:mod:`.common`); tensor control flow
becomes conditional nodes of a captured CUDA graph (:mod:`.control_flow`);
the sequence (LoD) ops use the padded-dense convention
(:mod:`.sequence_lod`); StaticRNN replays its recorded step over time
(:mod:`.rnn`).
"""
from .common import (  # noqa: F401
    batch_norm, bilinear_tensor_product, continuous_value_model, conv2d,
    conv2d_transpose, conv3d, conv3d_transpose, data_norm, deform_conv2d,
    embedding, fc, group_norm, instance_norm, layer_norm, nce, prelu,
    py_func, row_conv, sparse_embedding, spectral_norm,
)
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .rnn import StaticRNN  # noqa: F401
from .sequence_lod import (  # noqa: F401
    sequence_concat, sequence_conv, sequence_enumerate, sequence_expand,
    sequence_expand_as, sequence_first_step, sequence_last_step,
    sequence_pad, sequence_pool, sequence_reshape, sequence_reverse,
    sequence_scatter, sequence_slice, sequence_softmax, sequence_unpad,
)
from ..legacy import create_parameter  # noqa: F401

__all__ = [
    'fc',
    'batch_norm',
    'bilinear_tensor_product',
    'embedding',
    'case',
    'cond',
    'conv2d',
    'conv2d_transpose',
    'conv3d',
    'conv3d_transpose',
    'data_norm',
    'deform_conv2d',
    'group_norm',
    'instance_norm',
    'layer_norm',
    'nce',
    'prelu',
    'py_func',
    'row_conv',
    'spectral_norm',
    'switch_case',
    'while_loop',
    'sparse_embedding',
    'sequence_conv',
    'sequence_softmax',
    'sequence_pool',
    'sequence_concat',
    'sequence_first_step',
    'sequence_last_step',
    'sequence_slice',
    'sequence_expand',
    'sequence_expand_as',
    'sequence_pad',
    'sequence_unpad',
    'sequence_reshape',
    'sequence_scatter',
    'sequence_enumerate',
    'sequence_reverse',
    'StaticRNN',
]
