"""Twin runner of the ``nn`` layer tests: a case builds a layer from a
Paddle namespace ``P`` (``paddle_tpu`` or ``paddle_tpu_torch``);
:func:`twin` builds it in both packages, carries the JAX layer's
``state_dict`` into the port's with ``set_state_dict``, runs both on the
same numpy inputs and holds the outputs, the inputs' grads and every
parameter's grad equal at ``tol`` (f32)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle

TOL = 1e-5


def fresh_uids(layer):
    """Give each of the JAX layer's parameters a tape id of its own. Its
    ``TransformerEncoder``/``Decoder`` deep-copy their first layer, and a
    deep copy of a JAX ``Tensor`` keeps its ``_uid``, the key its tape
    accumulates grads under: the copies' grads then land on the first
    layer's parameters and theirs stay None. The twins hold the port to
    what the JAX code means, each layer with its own grads."""
    from paddle_tpu.tensor import _uid_counter

    for p in layer.parameters():
        p._uid = next(_uid_counter)
    return layer


def state_of(layer):
    """A layer's ``state_dict`` as numpy arrays."""
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _outputs(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _outputs(x)]
    return [out] if hasattr(out, "numpy") else []


def _run(P, layer, inputs, grad_inputs, seed, backward=True):
    ts = [P.to_tensor(a, stop_gradient=not (g and a.dtype.kind == "f"))
          for a, g in zip(inputs, grad_inputs)]
    outs = _outputs(layer(*ts))
    rng = np.random.default_rng(seed)
    loss = None
    for o in outs:
        if o.stop_gradient or not backward:
            continue
        cot = rng.standard_normal(o.shape).astype("float32")
        term = (o * P.to_tensor(cot)).sum()
        loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    grads = {f"input{i}": np.asarray(t.grad.numpy())
             for i, t in enumerate(ts) if t.grad is not None}
    grads.update({n: np.asarray(p.grad.numpy())
                  for n, p in layer.named_parameters() if p.grad is not None})
    return [np.asarray(o.numpy()) for o in outs], grads


def twin(make, inputs, tol=TOL, train=True, grad_inputs=None, seed=0,
         param_grads=True, relative_to_max=False):
    """Build ``make(P)`` in both packages (the port's from the JAX one's
    weights), run it on ``inputs`` (numpy arrays; float ones take grads
    unless ``grad_inputs`` says otherwise) and compare. ``param_grads``
    False compares the outputs and the inputs' grads only;
    ``relative_to_max`` holds each array's largest difference to ``tol``
    times its largest magnitude (not elementwise). Returns the port's
    layer."""
    grad_inputs = grad_inputs or [True] * len(inputs)
    pt.seed(seed)
    jl = make(pt)
    fresh_uids(jl)
    tl = make(paddle)
    missing, unexpected = tl.set_state_dict(state_of(jl))
    assert not missing and not unexpected, (missing, unexpected)
    for m in (jl, tl):
        m.train() if train else m.eval()
    # no backward where no gradient is compared
    backward = param_grads or any(
        g and a.dtype.kind == "f" for a, g in zip(inputs, grad_inputs))
    jo, jg = _run(pt, jl, inputs, grad_inputs, seed, backward)
    to, tg = _run(paddle, tl, inputs, grad_inputs, seed, backward)
    if not param_grads:
        jg, tg = ({k: v for k, v in g.items() if k.startswith("input")}
                  for g in (jg, tg))
    assert len(jo) == len(to) and jg.keys() == tg.keys(), (jg.keys(),
                                                           tg.keys())
    def close(b, a, what):
        if relative_to_max:
            diff, scale = np.abs(b - a).max(), np.abs(a).max()
            assert diff <= tol * scale, (what, diff, scale)
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=what)

    for i, (a, b) in enumerate(zip(jo, to)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        close(b, a, f"output {i}")
    for k in jg:
        close(tg[k], jg[k], f"grad {k}")
    return tl


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the test (ROADMAP ground rule 5)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def R(*shape, seed=0):
    """Seeded standard-normal f32."""
    return np.random.default_rng(seed).standard_normal(shape).astype("f4")


def grads_of(fn, *arrays, seed=7):
    """A case for ``both``: ``fn(P, *tensors)``'s outputs and the grads of
    the float inputs under a seeded cotangent on every float output."""
    def case(P):
        ts = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f")
              for a in arrays]
        out = fn(P, *ts)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        rng = np.random.default_rng(seed)
        loss = None
        for o in outs:
            if o.stop_gradient:
                continue
            term = (o * P.to_tensor(rng.standard_normal(o.shape)
                                    .astype("f4"))).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        return outs + [t.grad for t in ts if t.grad is not None]
    case.__name__ = getattr(fn, "__name__", "case")
    return case


def ties(seed=0):
    """A ReLU'd map: many equal zeros, small integers tying too."""
    rng = np.random.default_rng(seed)
    return np.maximum(rng.integers(-2, 3, (2, 3, 9, 9)), 0).astype("f4")
