"""``Router.reload`` of the port against the JAX package's (scenario 8 of
``tools/chaos_serve.py``), on tiny Llamas on the CPU.

Both routers serve the same base weights on two engines each (one model
instance a replica), reload the same donor checkpoint across a live
request stream, and must agree exactly: per-engine results, every live
request's finish reason and tokens, each engine's greedy stream after
the push, the reload counter's delta, ``weights_step`` and the step
programs (``compile_counts()`` unchanged across the push). The donor is
committed once by the JAX ``CheckpointManager`` and once by the port's
(``models.reference_state_dict``): either package's step reloads in
either router. A checkpoint missing a key refuses the load in both; the
port checks every key before writing any weight, where the JAX router
has already applied the keys present (ROADMAP Queue 3).
"""
import numpy as np
import pytest
import torch
from torch_router_common import (LLAMA, P3, P4, P5, P9, _carry,
                                 no_leaked_faults)
from torch_router_common import one_thread  # noqa: F401 (autouse)

import paddle_tpu as jpaddle
from paddle_tpu import checkpoint as jck
from paddle_tpu import metrics as jmetrics
from paddle_tpu import serving as jserving
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import checkpoint as tck
from paddle_tpu_torch import metrics as tmetrics
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     reference_state_dict)

PROMPTS = (P5, P9, P3, P4)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield from no_leaked_faults()


@pytest.fixture(scope="module")
def models():
    """Two JAX replicas and two port replicas of one base model, and the
    donor of another seed in both packages."""
    def jax_model(seed):
        jpaddle.seed(seed)
        return JaxLlama(jax_llama_tiny(**LLAMA))

    base = [jax_model(0), jax_model(0)]
    donor = jax_model(11)
    port = [_carry(base[0], LlamaForCausalLM(llama_tiny(**LLAMA),
                                             device="cpu"))
            for _ in range(2)]
    port_donor = _carry(donor, LlamaForCausalLM(llama_tiny(**LLAMA),
                                                device="cpu"))
    return base, donor, port, port_donor


def _fresh(models):
    """New replicas of the base weights (a reload writes into them)."""
    base, _donor, port, _pd = models
    jax_pair = []
    for _ in range(2):
        jpaddle.seed(0)
        jax_pair.append(JaxLlama(jax_llama_tiny(**LLAMA)))
    torch_pair = [_carry(base[0], LlamaForCausalLM(llama_tiny(**LLAMA),
                                                   device="cpu"))
                  for _ in range(2)]
    return jax_pair, torch_pair


def _counter(reg, name, **labels):
    fam = reg.get(name)
    return 0.0 if fam is None else (fam.labels(**labels) if labels
                                    else fam).value


def _drill(serving, reg, pair, ckpt_dir, kw):
    r = serving.Router()
    r.add_model("m", pair, page_size=4, max_batch_slots=1, **kw)
    warm = [r.submit(p, model="m", max_new_tokens=6) for p in PROMPTS]
    r.run()
    counts0 = [e.compile_counts() for e in r.engines("m")]
    live = [r.submit(p, model="m", max_new_tokens=6) for p in PROMPTS]
    r.step()
    ok0 = _counter(reg, "paddle_tpu_router_reloads_total", result="ok")
    summary = r.reload(ckpt_dir)
    outs = r.run()
    after = []
    for e in r.engines("m"):
        rid = e.add_request(P5, max_new_tokens=6)
        after.append(list(e.run()[rid].token_ids))
    return {
        "engines": [(x["engine_id"], x["result"], x.get("weights_step"))
                    for x in summary["engines"]],
        "step": summary["step"],
        "live": [(outs[k].finish_reason, list(outs[k].token_ids))
                 for k in live],
        "complete": sorted(outs) == sorted(live) and len(warm) == 4,
        "after": after,
        "reloads": _counter(reg, "paddle_tpu_router_reloads_total",
                            result="ok") - ok0,
        "weights_step": [h.weights_step for h in r.handles("m")],
        "counts_unchanged": [e.compile_counts() for e in r.engines("m")]
        == counts0,
        "states": r.states(),
    }


def _both_routers(models, ckpt_dir):
    jax_pair, torch_pair = _fresh(models)
    want = _drill(jserving, jmetrics.get_registry(), jax_pair, ckpt_dir, {})
    got = _drill(tserving, tmetrics.get_registry(), torch_pair, ckpt_dir,
                 {"device": "cpu"})
    return want, got, torch_pair


def test_reload_from_a_jax_checkpoint_matches_the_jax_router(models,
                                                             tmp_path):
    _base, donor, _port, port_donor = models
    jck.CheckpointManager(str(tmp_path), max_to_keep=None).save(
        1, {"model": donor.state_dict()})
    want, got, torch_pair = _both_routers(models, str(tmp_path))
    assert got == want
    assert got["complete"] and got["counts_unchanged"]
    assert got["engines"] == [("m/0", "ok", 1), ("m/1", "ok", 1)]
    assert all(r == "length" for r, _ in got["live"])
    assert got["reloads"] == 2 and got["weights_step"] == [1, 1]
    # every replica holds the donor's weights, in storage of its own
    ref = dict(port_donor.named_parameters())
    for m in torch_pair:
        for k, p in m.named_parameters():
            assert torch.equal(p, ref[k]), k
    p0 = dict(torch_pair[0].named_parameters())
    assert all(p.data_ptr() != p0[k].data_ptr()
               for k, p in torch_pair[1].named_parameters())
    # after the push each engine streams as the donor does
    eng = tserving.ServingEngine(port_donor, page_size=4,
                                 max_batch_slots=1, device="cpu")
    rid = eng.add_request(P5, max_new_tokens=6)
    assert got["after"] == [list(eng.run()[rid].token_ids)] * 2


def test_reload_from_a_port_checkpoint_matches_the_jax_router(models,
                                                              tmp_path):
    _base, _donor, _port, port_donor = models
    tck.CheckpointManager(str(tmp_path), max_to_keep=None,
                          device="cpu").save(
        1, {"model": reference_state_dict(port_donor)})
    want, got, _pair = _both_routers(models, str(tmp_path))
    assert got == want and got["complete"] and got["reloads"] == 2


def _partial(serving, reg, pair, ckpt_dir, kw):
    r = serving.Router()
    r.add_model("m", pair, page_size=4, max_batch_slots=1, **kw)
    err0 = _counter(reg, "paddle_tpu_router_reloads_total", result="error")
    with pytest.raises(ValueError, match="missing 1 model keys"):
        r.reload(ckpt_dir)
    return r.states(), _counter(reg, "paddle_tpu_router_reloads_total",
                                result="error") - err0


def test_a_missing_key_refuses_a_partial_load(models, tmp_path):
    _base, donor, _port, _pd = models
    sd = dict(donor.state_dict())
    dropped = "llama.layers.1.mlp.down_proj.weight"
    del sd[dropped]
    jck.CheckpointManager(str(tmp_path), max_to_keep=None).save(
        1, {"model": sd})
    jax_pair, torch_pair = _fresh(models)
    before = {k: p.detach().clone()
              for k, p in torch_pair[0].named_parameters()}
    jax_before = np.asarray(
        jax_pair[0].state_dict()["llama.embed_tokens.weight"].numpy())
    want = _partial(jserving, jmetrics.get_registry(), jax_pair,
                    str(tmp_path), {})
    got = _partial(tserving, tmetrics.get_registry(), torch_pair,
                   str(tmp_path), {"device": "cpu"})
    assert got == want == ({"m/0": "down", "m/1": "healthy"}, 1.0)
    # the port wrote nothing; the JAX router applied the keys present
    for k, p in torch_pair[0].named_parameters():
        assert torch.equal(p, before[k]), k
    assert not np.array_equal(
        np.asarray(jax_pair[0].state_dict()[
            "llama.embed_tokens.weight"].numpy()), jax_before)


def test_recover_rolls_the_checkpoint_in_first(models, tmp_path):
    """``recover(ckpt_dir=)`` reloads before replaying the WAL; with no
    committed step it raises and the fleet stays as it was."""
    _base, _donor, _port, port_donor = models
    _jp, torch_pair = _fresh(models)
    r = tserving.Router()
    r.add_model("m", torch_pair, page_size=4, max_batch_slots=1,
                device="cpu")
    with pytest.raises(tck.CheckpointNotFoundError):
        r.recover(wal_dir=str(tmp_path / "wal"),
                  ckpt_dir=str(tmp_path / "empty"))
    assert r.states() == {"m/0": "healthy", "m/1": "healthy"}
    tck.CheckpointManager(str(tmp_path / "ck"), device="cpu").save(
        3, {"model": reference_state_dict(port_donor)})
    assert r.recover(ckpt_dir=str(tmp_path / "ck")) == {}
    assert [h.weights_step for h in r.handles("m")] == [3, 3]
