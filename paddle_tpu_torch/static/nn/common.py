"""Static-graph layers that make their own parameters at build time
(``paddle_tpu/static/nn/common.py``): ``fc``, ``embedding``, the norms,
the convs, ``nce``, ``prelu``, ``spectral_norm`` and the rest (the
reference's ``static/nn/common.py`` and ``static/nn/loss.py``).

A static layer is a build-time call that makes real ``Parameter`` cells,
which ``Optimizer.minimize`` finds through the program's record
(``static._collect_parameters``), and runs ordinary ops, which the open
program records. Each runs eagerly, under ``Executor.run``'s replay or
inside ``jit.to_static``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...nn import functional as F
from ...nn.initializer import Constant, Normal, XavierNormal
from ...ops._apply import apply_op, ensure_tensor
from ...tensor import Parameter, Tensor
from ..legacy import py_func  # noqa: F401  (re-export; already static-shaped)
from ..legacy import create_parameter  # noqa: F401

__all__ = [
    "fc", "batch_norm", "instance_norm", "data_norm", "group_norm",
    "deform_conv2d", "conv2d", "conv3d", "conv2d_transpose",
    "conv3d_transpose", "bilinear_tensor_product", "py_func", "row_conv",
    "spectral_norm", "prelu", "layer_norm", "embedding", "sparse_embedding",
    "continuous_value_model", "nce",
]


def _act(out, act: Optional[str]):
    if act is None:
        return out
    fn = getattr(F, act, None)
    if fn is None:
        raise ValueError(f"unsupported activation {act!r}")
    return fn(out)


def _param(shape, dtype="float32", attr=None, is_bias=False, init=None):
    return create_parameter(shape, dtype, attr=attr, is_bias=is_bias,
                            default_initializer=init)


def fc(x, size: int, num_flatten_dims: int = 1, weight_attr=None,
       bias_attr=None, activation: Optional[str] = None, name=None):
    """reference: static/nn/common.py:28 — flatten trailing dims, xW+b."""
    x = ensure_tensor(x)
    if num_flatten_dims < 0:
        num_flatten_dims = x.ndim + num_flatten_dims
    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = _param([in_dim, size], x.dtype, attr=weight_attr)
    b = None if bias_attr is False else _param([size], x.dtype,
                                               attr=bias_attr, is_bias=True)
    nfd = num_flatten_dims
    # leading dims read from the runtime value: the Executor feeds
    # shape-polymorphic batches (static.data None dims)
    flat = apply_op(lambda v: v.reshape(*v.shape[:nfd], in_dim), [x],
                    name="fc_flatten")
    return _act(F.linear(flat, w, b), activation)


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False, padding_idx: Optional[int] = None,
              param_attr=None, dtype="float32"):
    """reference: static/nn/common.py embedding — creates the table."""
    w = _param(list(size), dtype, attr=param_attr,
               init=Normal(0.0, 1.0 / float(size[1]) ** 0.5))
    return F.embedding(ensure_tensor(input), w, padding_idx=padding_idx)


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32", slot=None):
    """reference: static/nn/common.py sparse_embedding (a parameter
    server's sparse table): here a dense table on the device, whose
    gather is the lookup; the server-side tables are
    ``distributed.ps``'s."""
    return embedding(input, size, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def batch_norm(input, act=None, is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               data_layout: str = "NCHW", in_place: bool = False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var: bool = True,
               use_global_stats: bool = False):
    """reference: static/nn/common.py:1471."""
    x = ensure_tensor(input)
    c_axis = 1 if data_layout.startswith("NC") else x.ndim - 1
    C = x.shape[c_axis]
    scale = _param([C], x.dtype, attr=param_attr, init=Constant(1.0))
    bias = _param([C], x.dtype, attr=bias_attr, is_bias=True)
    mean = Tensor(torch.zeros((C,), dtype=x.dtype, device=x._value.device))
    var = Tensor(torch.ones((C,), dtype=x.dtype, device=x._value.device))
    out = F.batch_norm(x, mean, var, weight=scale, bias=bias,
                       training=not is_test and not use_global_stats,
                       momentum=momentum, epsilon=epsilon,
                       data_format=data_layout)
    return _act(out, act)


def instance_norm(input, epsilon: float = 1e-5, param_attr=None,
                  bias_attr=None, name=None):
    """reference: static/nn/common.py instance_norm."""
    x = ensure_tensor(input)
    C = x.shape[1]
    scale = None if param_attr is False else _param([C], x.dtype,
                                                    attr=param_attr,
                                                    init=Constant(1.0))
    bias = None if bias_attr is False else _param([C], x.dtype,
                                                  attr=bias_attr,
                                                  is_bias=True)
    return F.instance_norm(x, weight=scale, bias=bias, eps=epsilon)


def data_norm(input, act=None, epsilon: float = 1e-5, param_attr=None,
              enable_scale_and_shift: bool = False, name=None,
              data_layout: str = "NCHW", do_model_average_for_mean_and_var=True,
              slot_dim: int = -1, sync_stats: bool = False,
              summary_decay_rate: float = 0.9999999):
    """reference: static/nn/common.py data_norm — normalization by learned
    batch summaries (batch_size / batch_sum / batch_square_sum), the CTR
    pipeline's streaming alternative to batch_norm."""
    x = ensure_tensor(input)
    D = x.shape[-1]
    batch_size = _param([D], x.dtype, init=Constant(1e4))
    batch_sum = _param([D], x.dtype, init=Constant(0.0))
    batch_sq = _param([D], x.dtype, init=Constant(1e4))

    def norm(v, n, s, sq):
        mean = s / n
        scale = torch.sqrt(n / torch.clamp(sq - s * mean, min=epsilon))
        return (v - mean) * scale

    out = apply_op(norm, [x, batch_size, batch_sum, batch_sq],
                   name="data_norm")
    if enable_scale_and_shift:
        scale = _param([D], x.dtype, attr=param_attr, init=Constant(1.0))
        shift = _param([D], x.dtype, attr=param_attr, is_bias=True)
        out = out * scale + shift
    return _act(out, act)


def group_norm(input, groups: int, epsilon: float = 1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout: str = "NCHW",
               name=None):
    """reference: static/nn/common.py group_norm."""
    x = ensure_tensor(input)
    c_axis = 1 if data_layout.startswith("NC") else x.ndim - 1
    C = x.shape[c_axis]
    scale = None if param_attr is False else _param([C], x.dtype,
                                                    attr=param_attr,
                                                    init=Constant(1.0))
    bias = None if bias_attr is False else _param([C], x.dtype,
                                                  attr=bias_attr,
                                                  is_bias=True)
    out = F.group_norm(x, groups, epsilon=epsilon, weight=scale, bias=bias,
                       data_format=data_layout)
    return _act(out, act)


def layer_norm(input, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    """reference: static/nn/common.py layer_norm — normalizes over dims
    [begin_norm_axis:]."""
    x = ensure_tensor(input)
    norm_shape = x.shape[begin_norm_axis:]
    w = _param(norm_shape, x.dtype, attr=param_attr,
               init=Constant(1.0)) if scale else None
    b = _param(norm_shape, x.dtype, attr=bias_attr,
               is_bias=True) if shift else None
    return _act(F.layer_norm(x, norm_shape, weight=w, bias=b,
                             epsilon=epsilon), act)


def _conv_nd(ndim, fname):
    default_df = "NCHW" if ndim == 2 else "NCDHW"

    def conv(input, num_filters: int, filter_size, stride=1, padding=0,
             dilation=1, groups=None, param_attr=None, bias_attr=None,
             use_cudnn: bool = True, act=None, name=None,
             data_format: str = None):
        data_format = data_format or default_df
        x = ensure_tensor(input)
        groups = groups or 1
        c_axis = 1 if data_format.startswith("NC") else x.ndim - 1
        C = x.shape[c_axis]
        ks = [filter_size] * ndim if isinstance(filter_size, int) \
            else list(filter_size)
        fan_in = C // groups * int(np.prod(ks))
        w = _param([num_filters, C // groups, *ks], x.dtype, attr=param_attr,
                   init=Normal(0.0, (2.0 / fan_in) ** 0.5))
        b = None if bias_attr is False else _param([num_filters], x.dtype,
                                                   attr=bias_attr,
                                                   is_bias=True)
        out = getattr(F, fname)(x, w, bias=b, stride=stride, padding=padding,
                                dilation=dilation, groups=groups,
                                data_format=data_format)
        return _act(out, act)
    conv.__name__ = fname
    return conv


conv2d = _conv_nd(2, "conv2d")
conv3d = _conv_nd(3, "conv3d")


def _conv_transpose_nd(ndim, fname):
    default_df = "NCHW" if ndim == 2 else "NCDHW"

    def convt(input, num_filters: int, output_size=None, filter_size=None,
              padding=0, stride=1, dilation=1, groups=None, param_attr=None,
              bias_attr=None, use_cudnn: bool = True, act=None, name=None,
              data_format: str = None):
        data_format = data_format or default_df
        x = ensure_tensor(input)
        groups = groups or 1
        if filter_size is None:
            raise ValueError(f"{fname}: filter_size is required (output_size"
                             "-derived filter inference is not supported)")
        c_axis = 1 if data_format.startswith("NC") else x.ndim - 1
        C = x.shape[c_axis]
        ks = [filter_size] * ndim if isinstance(filter_size, int) \
            else list(filter_size)
        w = _param([C, num_filters // groups, *ks], x.dtype, attr=param_attr,
                   init=XavierNormal())
        b = None if bias_attr is False else _param([num_filters], x.dtype,
                                                   attr=bias_attr,
                                                   is_bias=True)
        out = getattr(F, fname)(x, w, bias=b, stride=stride, padding=padding,
                                groups=groups, dilation=dilation,
                                output_size=output_size,
                                data_format=data_format)
        return _act(out, act)
    convt.__name__ = fname
    return convt


conv2d_transpose = _conv_transpose_nd(2, "conv2d_transpose")
conv3d_transpose = _conv_transpose_nd(3, "conv3d_transpose")


def deform_conv2d(input, offset, mask, num_filters: int, filter_size,
                  stride=1, padding=0, dilation=1, groups=None,
                  deformable_groups=None, im2col_step=None, param_attr=None,
                  bias_attr=None, name=None):
    """reference: static/nn/common.py deform_conv2d (v2 when mask given)."""
    from ...vision.ops import deform_conv2d as _dcn

    x = ensure_tensor(input)
    groups = groups or 1
    ks = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    C = x.shape[1]
    w = _param([num_filters, C // groups, *ks], x.dtype, attr=param_attr,
               init=XavierNormal())
    b = None if bias_attr is False else _param([num_filters], x.dtype,
                                               attr=bias_attr, is_bias=True)
    return _dcn(x, offset, w, mask=mask, bias=b, stride=stride,
                padding=padding, dilation=dilation,
                deformable_groups=deformable_groups or 1, groups=groups)


def bilinear_tensor_product(x, y, size: int, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """reference: static/nn/common.py bilinear_tensor_product —
    out_k = x W_k yᵀ + b."""
    x, y = ensure_tensor(x), ensure_tensor(y)
    dx, dy = x.shape[-1], y.shape[-1]
    w = _param([size, dx, dy], x.dtype, attr=param_attr, init=XavierNormal())
    b = None if bias_attr is False else _param([size], x.dtype,
                                               attr=bias_attr, is_bias=True)
    ins = [x, y, w] + ([b] if b is not None else [])

    def btp(xv, yv, wv, *rest):
        out = torch.einsum("bi,kij,bj->bk", xv, wv, yv)
        return out + rest[0] if rest else out

    return _act(apply_op(btp, ins, name="bilinear_tensor_product"), act)


def row_conv(input, future_context_size: int, param_attr=None, act=None):
    """reference: static/nn/common.py row_conv — lookahead convolution:
    out[t] = Σ_{i=0..k} x[t+i] ⊙ w[i] (zero past the end)."""
    x = ensure_tensor(input)
    D = x.shape[-1]
    k = int(future_context_size)
    w = _param([k + 1, D], x.dtype, attr=param_attr, init=Constant(0.0))

    def rc(v, wv):
        T = v.shape[-2]
        vp = torch.nn.functional.pad(v, (0, 0, 0, k))
        out = sum(vp[..., i:T + i, :] * wv[i] for i in range(k + 1))
        return out

    return _act(apply_op(rc, [x, w], name="row_conv"), act)


def spectral_norm(weight, dim: int = 0, power_iters: int = 1,
                  eps: float = 1e-12, name=None):
    """reference: static/nn/common.py:2158 — W / σ(W) by power iteration."""
    w = ensure_tensor(weight)
    h = w.shape[dim]

    def sn(wv):
        mat = torch.movedim(wv, dim, 0).reshape(h, -1)
        u = torch.ones((h,), dtype=wv.dtype, device=wv.device) / torch.sqrt(
            torch.tensor(h, dtype=wv.dtype, device=wv.device))
        v = None
        for _ in range(max(1, power_iters)):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        sigma = u @ mat @ v
        return wv / sigma

    return apply_op(sn, [w], name="spectral_norm")


def prelu(x, mode: str, param_attr=None, data_format: str = "NCHW",
          name=None):
    """reference: static/nn/common.py prelu — modes all/channel/element."""
    x = ensure_tensor(x)
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        c_axis = 1 if data_format.startswith("NC") else x.ndim - 1
        shape = [x.shape[c_axis]]
    elif mode == "element":
        shape = list(x.shape[1:])
    else:
        raise ValueError(f"prelu: bad mode {mode!r}")
    alpha = _param(shape, x.dtype, attr=param_attr, init=Constant(0.25))

    def pr(v, a):
        if mode == "channel" and data_format.startswith("NC"):
            a = a.reshape((1, -1) + (1,) * (v.ndim - 2))
        return torch.where(v >= 0, v, v * a)

    return apply_op(pr, [x, alpha], name="prelu")


def continuous_value_model(input, cvm, use_cvm: bool = True):
    """reference: static/nn/common.py continuous_value_model — CTR cvm op:
    keep (use_cvm) or strip the leading show/click columns."""
    x = ensure_tensor(input)
    if use_cvm:
        return apply_op(lambda v: v, [x], name="cvm")
    return apply_op(lambda v: v[:, 2:], [x], name="cvm")


def nce(input, label, num_total_classes: int, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples: Optional[int] = None,
        name=None, sampler: str = "uniform", custom_dist=None, seed: int = 0,
        is_sparse: bool = False):
    """reference: static/nn/loss.py nce — noise-contrastive estimation.

    The negatives are drawn on the host once, at build time (a fixed
    sample set, uniform or log-uniform, numpy's generator as in the JAX
    package); the loss is the binary NCE objective -log σ(s⁺) - Σ log
    σ(-s⁻), batched as one product."""
    x = ensure_tensor(input)
    lbl = ensure_tensor(label)
    D = x.shape[-1]
    n_neg = int(num_neg_samples or 10)
    w = _param([num_total_classes, D], x.dtype, attr=param_attr,
               init=Normal(0.0, 1.0 / D ** 0.5))
    b = None if bias_attr is False else _param([num_total_classes], x.dtype,
                                               attr=bias_attr, is_bias=True)
    rng = np.random.RandomState(seed or 1)
    if sampler == "log_uniform":
        p = 1.0 / np.arange(1, num_total_classes + 1)
        p /= p.sum()
        neg = rng.choice(num_total_classes, size=(n_neg,), p=p)
    elif sampler == "custom_dist" and custom_dist is not None:
        p = np.asarray(custom_dist, dtype=np.float64)
        neg = rng.choice(num_total_classes, size=(n_neg,), p=p / p.sum())
    else:
        neg = rng.randint(0, num_total_classes, size=(n_neg,))
    neg = torch.as_tensor(np.asarray(neg, np.int64))

    ins = [x, lbl, w] + ([b] if b is not None else [])

    def nce_loss(xv, lv, wv, *rest):
        bv = rest[0] if rest else torch.zeros((num_total_classes,),
                                              dtype=xv.dtype,
                                              device=xv.device)
        ng = neg.to(xv.device)
        lv = lv.reshape(-1).to(torch.int64)
        pos_s = torch.sum(xv * wv[lv], dim=-1) + bv[lv]
        neg_s = xv @ wv[ng].T + bv[ng]
        sp = torch.nn.functional.softplus
        loss = sp(-pos_s) + torch.sum(sp(neg_s), dim=-1)
        return loss[:, None]

    return apply_op(nce_loss, ins, name="nce")
