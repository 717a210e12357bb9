"""The named recompute policies of paddle_tpu_torch.distributed.fleet.
recompute and GPT's ``recompute`` flag, against the JAX package's
(``distributed/fleet/recompute.py`` ``_POLICIES``, ``models/gpt.py``).

A tiny GPT (and Llama) built from the JAX package's seed and carried
across runs one forward and backward under each policy in both packages:
loss and every parameter's grad agree at f32 atol = rtol = 1e-5, and in
the port each policy's are bit-equal to no recompute. What a policy
saves shows in the backward: the matrix products it did not save are
dispatched again there (counted under a ``TorchDispatchMode``).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as pt
from paddle_tpu.distributed.fleet import recompute as jrecompute
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.distributed.fleet.recompute import POLICIES, recompute
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny,
                                     load_reference_state_dict)
from paddle_tpu_torch.optimizer import AdamW

TOL = 1e-5
NAMES = [None, "full", "dots", "dots_saveable", "dots_no_batch",
         "dots_with_no_batch_dims"]
BUILD = {"gpt": (JaxGPT, jax_gpt_tiny, GPTForCausalLM, gpt_tiny),
         "llama": (JaxLlama, jax_llama_tiny, LlamaForCausalLM, llama_tiny)}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm", "bmm", "baddbmm"):
            self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _ids():
    ids = np.random.default_rng(0).integers(0, 128, (2, 16))
    return ids, np.roll(ids, -1, axis=1)


def _run_port(name, policy, ref):
    tcls, tcfg = BUILD[name][2:]
    tm = tcls(tcfg(vocab_size=128, recompute=policy is not None,
                   recompute_policy=policy), device="cpu")
    load_reference_state_dict(tm, ref)
    ids, labels = _ids()
    _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    with _Products() as counted:
        loss.backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    return loss.detach(), grads, linear, counted.n


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (jcls, jcfg, _t, _c) in BUILD.items():
        pt.seed(0)
        ref = {k: np.asarray(v.numpy()) for k, v in
               jcls(jcfg(vocab_size=128)).state_dict().items()}
        out[name] = (ref, {p: _run_port(name, p, ref) for p in NAMES})
    return out


@pytest.mark.parametrize("policy", NAMES[1:])
@pytest.mark.parametrize("name", sorted(BUILD))
def test_policy_equals_no_recompute_and_the_jax_package(runs, name, policy):
    ref, ports = runs[name]
    base_loss, base_grads, linear, _ = ports[None]
    loss, grads, _, _ = ports[policy]
    assert torch.equal(loss, base_loss)
    for n, g in grads.items():
        assert torch.equal(g, base_grads[n]), n
    jcls, jcfg = BUILD[name][:2]
    pt.seed(0)
    jm = jcls(jcfg(vocab_size=128, recompute=True, recompute_policy=policy))
    jm.set_state_dict({k: pt.to_tensor(v) for k, v in ref.items()})
    ids, labels = _ids()
    _, jloss = jm(pt.to_tensor(ids), labels=pt.to_tensor(labels))
    jloss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                               rtol=TOL, atol=TOL)
    for n, p in jm.named_parameters():
        got = grads[n].numpy()
        np.testing.assert_allclose(got.T if n in linear else got,
                                   np.asarray(p.grad.numpy()), rtol=TOL,
                                   atol=TOL, err_msg=n)


def test_saved_products_per_policy(runs):
    """The backward of a 2-layer GPT re-dispatches what the policy did not
    save: under ``full`` the layers' linears (``addmm``, up to the last
    one the backward needs: 3 a layer) and attention's two batched
    products a layer; under ``dots`` none; under ``dots_no_batch`` only
    the batched ones."""
    counts = {p: c for p, (_l, _g, _lin, c) in runs["gpt"][1].items()}
    base = counts[None]
    extra = {p: {k: c.get(k, 0) - base.get(k, 0) for k in ("addmm", "bmm")}
             for p, c in counts.items()}
    assert extra["full"] == {"addmm": 6, "bmm": 4}
    assert extra["dots"] == extra["dots_saveable"] == {"addmm": 0, "bmm": 0}
    assert extra["dots_no_batch"] == extra["dots_with_no_batch_dims"] == \
        {"addmm": 0, "bmm": 4}


def test_everything_and_nothing_saveable():
    """The JAX names of the two extremes: ``nothing_saveable`` recomputes
    as ``full`` does, ``everything_saveable`` recomputes nothing."""
    layer = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(),
                                torch.nn.Linear(16, 8))
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    want = layer(x).pow(2).sum()
    gx, = torch.autograd.grad(want, x)
    for policy, rerun in (("nothing_saveable", 1),
                          ("everything_saveable", 0)):
        out = recompute(layer, x, policy=policy).pow(2).sum()
        with _Products() as counted:
            got, = torch.autograd.grad(out, x)
        assert torch.equal(got, gx) and torch.equal(out, want)
        # the input grads of the two linears (2 mm), and the first linear
        # rerun (addmm: the GELU's backward needs its output) unless saved
        assert counted.n == {"mm": 2, **({"addmm": 1} if rerun else {})}


def test_unknown_and_jax_only_policies_raise():
    """The port accepts the JAX package's ``_POLICIES`` names and the two
    extremes; other ``jax.checkpoint_policies`` names and callables over
    primitives raise, naming what it accepts (ROADMAP Queue 3,
    differences by design). An unknown name raises in both packages."""
    layer = torch.nn.Linear(4, 4)
    x = torch.ones(2, 4, requires_grad=True)
    for policy in ("bogus", "offload_dot_with_no_batch_dims",
                   "save_only_these_names", lambda *a, **k: True):
        with pytest.raises(ValueError, match="named options"):
            recompute(layer, x, policy=policy)
    with pytest.raises(ValueError):
        jrecompute(pt.nn.Linear(4, 4), pt.to_tensor(np.ones((2, 4), "f4")),
                   policy="bogus")
    assert set(POLICIES) >= {"full", "dots", "dots_saveable",
                             "dots_no_batch", "dots_with_no_batch_dims"}


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_gpt_trains_with_the_recompute_flag(policy):
    """Three AdamW steps of a GPT with dropout under recompute: the losses
    and parameters equal those without it bit for bit (the rerun draws
    the forward's dropout seeds again)."""
    ids, labels = (torch.from_numpy(a) for a in _ids())

    def train(rc):
        m = GPTForCausalLM(gpt_tiny(vocab_size=128, recompute=rc,
                                    recompute_policy=policy if rc else None,
                                    hidden_dropout_prob=0.1,
                                    attention_dropout_prob=0.1),
                           device="cpu", seed=4)
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        import paddle_tpu_torch as paddle

        paddle.seed(7)
        losses = []
        for _ in range(3):
            _, loss = m(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        return losses, [p.detach().clone() for p in m.parameters()]

    (l0, p0), (l1, p1) = train(False), train(True)
    assert l0 == l1 and l0[0] != l0[2]
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
