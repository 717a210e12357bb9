"""paddle_tpu_torch.amp against the JAX package's amp: the per-op cast
rule (its tape's ``_amp_cast`` under ``amp.auto_cast``) and
``amp.decorate``.

For every op name on GPT's training path, and a few off it, under O1 and
O2 (and with custom lists), the port's ``cast_inputs`` must give each
input the dtype the JAX package's rule gives it: f32 for the black list,
the amp dtype under O2 or for the white list under O1, unchanged
otherwise, integers never cast. Exact, as dtypes are.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu.autograd import engine
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.optimizer import AdamW

OPS = ["linear", "matmul", "layer_norm", "gelu", "add", "flash_attention",
       "scaled_dot_product_attention", "fused_linear_cross_entropy",
       "cross_entropy", "embedding", "dropout", "softmax", "split_heads"]
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "int32": torch.int32}


def _rule(name, level, **lists):
    jins = [jnp.zeros(2, _J[d]) for d in _J]
    tins = [torch.zeros(2, dtype=_T[d]) for d in _T]
    with jamp.auto_cast(level=level, dtype="bfloat16", **lists):
        want = [str(a.dtype) for a in engine._amp_cast(jins, name)] \
            if engine.amp_state["enabled"] else [str(a.dtype) for a in jins]
    with amp.auto_cast(level=level, dtype="bfloat16", **lists):
        got = [str(t.dtype).split(".")[-1] for t in amp.cast_inputs(name,
                                                                    *tins)]
    return got, want


@pytest.mark.parametrize("level", ["O0", "O1", "O2"])
def test_cast_rule_matches(level):
    for name in OPS:
        got, want = _rule(name, level)
        assert got == want, (name, level)


def test_custom_lists_match():
    lists = dict(custom_white_list=["gelu", "cross_entropy"],
                 custom_black_list=["linear"])
    for level in ("O1", "O2"):
        for name in OPS:
            got, want = _rule(name, level, **lists)
            assert got == want, (name, level)


def test_no_cast_outside_auto_cast():
    x = torch.zeros(2)
    assert amp.cast_inputs("linear", x)[0] is x
    with amp.auto_cast(level="O2"):
        assert amp.cast_inputs("gelu", x)[0].dtype == torch.bfloat16
        with amp.auto_cast(enable=False):
            assert amp.cast_inputs("gelu", x)[0] is x
        assert amp.cast_inputs("layer_norm", x.bfloat16())[0].dtype == \
            torch.float32
    assert amp.cast_inputs("gelu", x)[0] is x
    with pytest.raises(ValueError):
        with amp.auto_cast(level="O3"):
            pass


@pytest.mark.parametrize("master", [None, False])
def test_decorate_keeps_norms_f32(master):
    model = GPTForCausalLM(gpt_tiny(num_layers=1), device="cpu", seed=0)
    opt = AdamW(parameters=model.named_parameters())
    params_before = {n: id(p) for n, p in model.named_parameters()}
    model, opt = amp.decorate(model, opt, level="O2", master_weight=master)
    for n, p in model.named_parameters():
        assert id(p) == params_before[n]  # the optimizer's references hold
        assert p.dtype == (torch.float32 if ".ln" in n else torch.bfloat16), n
    assert opt._multi_precision == (master is not False)
    untouched = GPTForCausalLM(gpt_tiny(num_layers=1), device="cpu", seed=0)
    assert amp.decorate(untouched, level="O1") is untouched
    assert all(p.dtype == torch.float32 for p in untouched.parameters())
    np.testing.assert_array_equal(
        model.gpt.ln_f.weight.detach().numpy(), np.ones(128, np.float32))
