"""paddle_tpu_torch.optimizer.lr against the JAX package's schedulers.

The port's ``optimizer/lr.py`` is a copy of the JAX package's (which is
jax-free), so every one of the 18 schedulers (the ``LRScheduler`` base,
through a subclass, and the 17 built on it) must give the same value at
each of 40 steps, exactly, and the same ``state_dict``; a state dict
taken half way and
loaded into a fresh scheduler of the other package must continue the
same values. ``ReduceOnPlateau`` is fed the same metrics on both sides.
Through an optimizer, ``get_lr`` follows the scheduler in both packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 40

# name: keyword arguments (the same for both packages)
SCHEDULERS = {
    "LRScheduler": dict(learning_rate=0.3),
    "NoamDecay": dict(d_model=64, warmup_steps=10, learning_rate=1.0),
    "PiecewiseDecay": dict(boundaries=[5, 15, 25],
                           values=[1.0, 0.5, 0.1, 0.01]),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.1),
    "PolynomialDecay": dict(learning_rate=0.5, decay_steps=12, end_lr=0.01,
                            power=2.0, cycle=True),
    "LinearWarmup": dict(learning_rate=0.5, warmup_steps=10, start_lr=0.0,
                         end_lr=0.5),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[5, 20], gamma=0.1),
    "StepDecay": dict(learning_rate=0.5, step_size=7, gamma=0.5),
    "LambdaDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.9),
    "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=15, eta_min=0.01),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.5, T_0=7, T_mult=2,
                                        eta_min=0.01),
    "ReduceOnPlateau": dict(learning_rate=0.5, patience=2, factor=0.5,
                            cooldown=1),
    "LinearLR": dict(learning_rate=0.5, total_steps=20, start_factor=0.2,
                     end_factor=1.0),
    "OneCycleLR": dict(max_learning_rate=0.5, total_steps=STEPS + 1),
    "CyclicLR": dict(base_learning_rate=0.05, max_learning_rate=0.5,
                     step_size_up=6),
}

# the metric ReduceOnPlateau is fed: falls, then plateaus, then falls
METRICS = np.concatenate([np.linspace(5.0, 2.0, 10), np.full(15, 2.0),
                          np.linspace(2.0, 1.0, 15)])


def _make(mod, name):
    """The scheduler class ``name`` of ``mod``; the base, whose
    ``get_lr`` is abstract, through a subclass that halves its lr every
    third epoch."""
    cls = getattr(mod, name)
    if name != "LRScheduler":
        return cls
    return type("Thirds", (cls,), {
        "get_lr": lambda self: self.base_lr * 0.5 ** (self.last_epoch // 3)})


def _step(s, i):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(float(METRICS[i]))
    else:
        s.step()


def _values(s, start=0, stop=STEPS):
    out = []
    for i in range(start, stop):
        out.append(s())
        _step(s, i)
    return out


def test_every_scheduler_is_ported():
    assert sorted(tlr.__all__) == sorted(jlr.__all__) == sorted(SCHEDULERS)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_values_and_state_dict_twin(name):
    """Equal values at every step, equal state dicts, and a state dict
    carried across packages half way continues the same values."""
    j = _make(jlr, name)(**SCHEDULERS[name])
    t = _make(tlr, name)(**SCHEDULERS[name])
    half = STEPS // 2
    assert _values(t, 0, half) == _values(j, 0, half)
    assert t.state_dict() == j.state_dict()
    # a fresh scheduler of each package loads the other's state
    t2 = _make(tlr, name)(**SCHEDULERS[name])
    j2 = _make(jlr, name)(**SCHEDULERS[name])
    t2.set_state_dict(j.state_dict())
    j2.set_state_dict(t.state_dict())
    rest_j = _values(j, half, STEPS)
    assert _values(t, half, STEPS) == rest_j
    assert _values(t2, half, STEPS) == rest_j
    assert _values(j2, half, STEPS) == rest_j
    assert t.state_dict() == j.state_dict()


def test_base_get_lr_is_abstract_twin():
    for mod in (jlr, tlr):
        with pytest.raises(NotImplementedError):
            mod.LRScheduler(learning_rate=0.1)


def test_reduce_on_plateau_reduces():
    """The plateau in METRICS makes both packages cut the lr, at the same
    steps."""
    j = jlr.ReduceOnPlateau(**SCHEDULERS["ReduceOnPlateau"])
    t = tlr.ReduceOnPlateau(**SCHEDULERS["ReduceOnPlateau"])
    vals = _values(t)
    assert vals == _values(j)
    assert min(vals) < vals[0]


def test_optimizer_follows_scheduler_twin():
    """``get_lr`` of an SGD over a scheduler, in both packages, as the
    scheduler steps; ``set_lr`` raises under a scheduler; the scheduler's
    state rides in the optimizer's ``state_dict``."""
    js = jlr.StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
    ts = tlr.StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
    jo = pt.optimizer.SGD(learning_rate=js, parameters=[
        pt.Parameter(np.zeros(2, np.float32))])
    to = SGD(learning_rate=ts,
             parameters=[torch.nn.Parameter(torch.zeros(2))])
    for _ in range(5):
        assert to.get_lr() == jo.get_lr()
        js.step()
        ts.step()
    with pytest.raises(RuntimeError):
        to.set_lr(0.5)
    assert to.state_dict()["LR_Scheduler"] == jo.state_dict()["LR_Scheduler"]
