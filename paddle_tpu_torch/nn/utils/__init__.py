"""``nn.utils`` (``paddle_tpu/nn/utils``): weight_norm and spectral_norm
as forward pre-hooks, parameters to a vector and back, and the in-place
grad clips ``clip_grad_norm_`` and ``clip_grad_value_``.

Writes into parameters and buffers are in place (``copy_``), as every
write of the port's Layers is.
"""
from __future__ import annotations

import torch

from ...autograd.engine import apply_op
from ...generator import device_generator
from ...tensor import Parameter, Tensor

__all__ = [
    "weight_norm", "remove_weight_norm", "spectral_norm",
    "parameters_to_vector", "vector_to_parameters",
    "clip_grad_norm_", "clip_grad_value_",
]


def _norm_except(w, dim):
    if dim is None:
        return torch.sqrt((w ** 2).sum())
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt((w ** 2).sum(axes, keepdim=True))


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """Reparameterise ``weight = g * v / ||v||`` (the norm over every
    axis but ``dim``), recomputed by a forward pre-hook."""
    w = getattr(layer, name)
    v0 = w._value.detach()
    g0 = _norm_except(v0, dim)
    trainable = not w.stop_gradient
    layer.add_parameter(name + "_v", Parameter(v0, trainable=trainable))
    layer.add_parameter(name + "_g", Parameter(
        g0.reshape(-1) if dim is not None else g0, trainable=trainable))
    del layer._parameters[name]

    def hook(lyr, inputs):
        def fn(v_, g_):
            if dim is not None:
                shape = [1] * v_.dim()
                shape[dim] = -1
                g_ = g_.reshape(shape)
            return g_ * v_ / torch.clamp_min(_norm_except(v_, dim), 1e-12)

        lyr.__dict__[name] = apply_op(fn, [getattr(lyr, name + "_v"),
                                           getattr(lyr, name + "_g")],
                                      name="weight_norm")
        return None

    layer.__dict__["_weight_norm_handle_" + name] = \
        layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Fold ``g * v / ||v||`` back into one parameter ``name``."""
    handle = layer.__dict__.pop("_weight_norm_handle_" + name, None)
    if handle is not None:
        handle.remove()
    v = getattr(layer, name + "_v")
    w = layer.__dict__.pop(name, None)
    value = (w if w is not None else v)._value.detach()
    layer.add_parameter(name, Parameter(value,
                                        trainable=not v.stop_gradient))
    del layer._parameters[name + "_v"]
    del layer._parameters[name + "_g"]
    return layer


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim=None):
    """Divide the weight by its largest singular value, estimated by
    power iteration whose vectors (buffers ``<name>_u``, ``<name>_v``,
    written in place) persist across forwards."""
    if dim is None:
        dim = 1 if type(layer).__name__.endswith("Transpose") else 0
    w = getattr(layer, name)
    wv = w._value.detach()
    wm = wv.movedim(dim, 0).reshape(wv.shape[dim], -1)
    gen = device_generator(wv.device)
    u = torch.randn(wm.shape[0], generator=gen, device=wv.device)
    v = torch.randn(wm.shape[1], generator=gen, device=wv.device)
    layer.register_buffer(name + "_u", Tensor(u / torch.linalg.vector_norm(u)))
    layer.register_buffer(name + "_v", Tensor(v / torch.linalg.vector_norm(v)))
    layer.add_parameter(name + "_orig",
                        Parameter(wv, trainable=not w.stop_gradient))
    del layer._parameters[name]

    def hook(lyr, inputs):
        w_orig = getattr(lyr, name + "_orig")
        u_, v_ = lyr._buffers[name + "_u"]._value, \
            lyr._buffers[name + "_v"]._value
        with torch.no_grad():
            wmat = w_orig._value.movedim(dim, 0).reshape(
                w_orig.shape[dim], -1)
            for _ in range(n_power_iterations):
                v_.copy_(wmat.T @ u_)
                v_.div_(torch.clamp_min(torch.linalg.vector_norm(v_), eps))
                u_.copy_(wmat @ v_)
                u_.div_(torch.clamp_min(torch.linalg.vector_norm(u_), eps))
        uc, vc = u_.clone(), v_.clone()

        def fn(w_):
            wm_ = w_.movedim(dim, 0).reshape(w_.shape[dim], -1)
            return w_ / (uc @ wm_ @ vc)

        lyr.__dict__[name] = apply_op(fn, [w_orig], name="spectral_norm")
        return None

    layer.__dict__["_spectral_norm_handle_" + name] = \
        layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def parameters_to_vector(parameters, name=None) -> Tensor:
    """The parameters' values, flattened and concatenated (a copy)."""
    return Tensor(torch.cat([p._value.detach().reshape(-1)
                             for p in parameters]))


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None) -> None:
    """Slice ``vec`` back into the parameters, in place."""
    v = getattr(vec, "_value", vec)
    v = torch.as_tensor(v)
    offset = 0
    for p in parameters:
        n = p._value.numel()
        p._value.copy_(v[offset: offset + n].reshape(p._value.shape))
        offset += n


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False):
    """Scale every grad in place so their joint ``norm_type`` norm is at
    most ``max_norm``; returns the norm before clipping (a 0-d Tensor)."""
    params = [parameters] if isinstance(parameters, Tensor) \
        else list(parameters)
    grads = [p._value.grad for p in params if p._value.grad is not None]
    if not grads:
        return Tensor(torch.zeros(()))
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([(g.float().abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"the total norm of the gradients is {total}")
    factor = torch.clamp(max_norm / torch.clamp_min(total, 1e-6), max=1.0)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return Tensor._wrap(total)


@torch.no_grad()
def clip_grad_value_(parameters, clip_value: float) -> None:
    """Clamp every grad to ``[-clip_value, clip_value]`` in place."""
    params = [parameters] if isinstance(parameters, Tensor) \
        else list(parameters)
    for p in params:
        if p._value.grad is not None:
            p._value.grad.clamp_(-clip_value, clip_value)
