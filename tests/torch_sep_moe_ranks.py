"""Rank-side code of the sequence- and expert-parallel twins: each
function runs in every gloo rank of one
``paddle_tpu_torch.distributed.spawn`` job (one intra-op thread a rank)
and returns numpy. It imports ``paddle_tpu_torch``, torch and numpy only;
the test files hold the results against the JAX package in the pytest
process.
"""
import numpy as np


def _init():
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist

    paddle.set_device("cpu")
    dist.init_parallel_env(mesh_axes={})
    return dist


def _np(t):
    v = getattr(t, "_value", t)
    return v.detach().float().numpy().copy()


def _fleet(**degrees):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _no_mesh():
    from paddle_tpu_torch.distributed import topology

    topology.set_mesh(None)


# ---------------------------------------------------- ring attention
def _ring(q, k, v, causal, scale=None, grads=False):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import ring_attention

    ts = [paddle.to_tensor(x, stop_gradient=not grads) for x in (q, k, v)]
    out = ring_attention(*ts, causal=causal, scale=scale)
    if not grads:
        return _np(out)
    (out * out).sum().backward()
    return [_np(t.grad) for t in ts]


def ring_attention_cases(data):
    """``tests/test_ring_attention.py``'s cases at ``sep`` 4 (four ranks),
    then at ``sep`` 2 beside ``dp`` 2; the fallback without a mesh; and
    the flash calls a rank's ring makes (plain versions on the CPU)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    dist = _init()
    out = {"rank": dist.get_rank()}
    for sep, degrees in ((4, {"sep": 4}), (2, {"dp": 2, "sep": 2})):
        _fleet(**degrees)
        q, k, v = data["dense"]
        for causal in (False, True):
            out[f"dense_{causal}_sep{sep}"] = _ring(q, k, v, causal)
        fa.reset_counters()
        out[f"grads_sep{sep}"] = _ring(*data["grads"], True, grads=True)
        out[f"flash_calls_sep{sep}"] = dict(fa.plain_calls)
        out[f"scale_sep{sep}"] = _ring(*data["scale"], False, scale=0.5)
        try:
            _ring(*data[f"indivisible_sep{sep}"], False)
            out[f"indivisible_sep{sep}"] = None
        except ValueError as e:
            out[f"indivisible_sep{sep}"] = str(e)
        _no_mesh()
    out["fallback"] = _ring(*data["fallback"], False)
    out["scale_fallback"] = _ring(*data["scale"], False, scale=0.5)
    dist.destroy_process_group()
    return out


# ---------------------------------------------- sequence-parallel models
def _model(kind, cfg_kw, weights, sep):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.models.convert import load_reference_state_dict

    paddle.seed(0)
    if kind == "gpt":
        model = GPTForCausalLM(GPTConfig(sequence_parallel=sep, **cfg_kw),
                               device="cpu", seed=0)
    else:
        model = LlamaForCausalLM(LlamaConfig(sequence_parallel=sep,
                                             **cfg_kw), device="cpu", seed=0)
    load_reference_state_dict(model, weights)
    return model


def _grads(model):
    """The gradients by the reference's names and layouts (a Linear's
    ``[in, out]``)."""
    import torch

    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    return {k: _np(p.grad.t() if k in linear else p.grad)
            for k, p in model.named_parameters()}


def _train_step(model, ids, labels, wrap):
    import torch

    net = wrap(model) if wrap else model
    _, loss = net(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), _grads(model)


def sequence_parallel_cases(data):
    """The models' ``sep`` paths on four ranks (module docstring of the
    test file): GPT's logits at ``sep`` 4 and at ``sep`` 1; Llama's loss
    and gradients at ``sep`` 2 beside ``dp`` 2 through
    ``fleet.distributed_model`` (each ``dp`` group its half of the
    batch), and with unequal ignored labels per chunk; GPT with attention
    dropout in training at ``sep`` 4 and at ``sep`` 1."""
    import torch

    from paddle_tpu_torch.distributed import fleet

    dist = _init()
    rank = dist.get_rank()
    out = {"rank": rank}
    g = data["gpt"]
    ids = torch.from_numpy(g["ids"])

    # given position ids, a permutation of the positions
    pos = torch.from_numpy(np.tile((np.arange(ids.shape[1]) * 7)
                                   % ids.shape[1], (ids.shape[0], 1)))

    def gpt_logits(sep, train=False, kw=None, positions=None):
        import paddle_tpu_torch as paddle

        m = _model("gpt", dict(g["cfg"], **(kw or {})), g["weights"], sep)
        m.train() if train else m.eval()
        paddle.seed(11)
        with torch.no_grad():
            return _np(m(ids, position_ids=positions))

    drop = {"attention_dropout_prob": 0.5}
    for sep, degrees in ((4, {"sep": 4}), (1, None)):
        if degrees:
            _fleet(**degrees)
        out[f"gpt_sep{sep}"] = gpt_logits(sep > 1)
        out[f"gpt_positions_sep{sep}"] = gpt_logits(sep > 1, positions=pos)
        out[f"gpt_dropout_sep{sep}"] = gpt_logits(sep > 1, True, drop)
        _no_mesh()

    ll = data["llama"]
    half = ll["ids"].shape[0] // 2
    hcg = _fleet(dp=2, sep=2)
    d = hcg.get_data_parallel_rank()
    rows = slice(d * half, (d + 1) * half)
    for name, labels in (("llama", ll["labels"]),
                         ("llama_ignored", ll["labels_ignored"])):
        m = _model("llama", ll["cfg"], ll["weights"], True)
        ids_b, lab_b = ll["ids"], labels
        if name == "llama":  # dp groups each take their half
            ids_b, lab_b = ids_b[rows], lab_b[rows]
        out[name] = _train_step(m, ids_b, lab_b, fleet.distributed_model)
    _no_mesh()
    m = _model("llama", ll["cfg"], ll["weights"], False)
    out["llama_dense"] = _train_step(m, ll["ids"], ll["labels"], None)
    m = _model("llama", ll["cfg"], ll["weights"], False)
    out["llama_ignored_dense"] = _train_step(m, ll["ids"],
                                             ll["labels_ignored"], None)
    with torch.no_grad():  # each sep chunk's own mean loss
        logits = m(torch.from_numpy(ll["ids"]))
        lab = torch.from_numpy(ll["labels_ignored"])
        tok = torch.nn.functional.cross_entropy(
            logits.transpose(1, 2), lab, ignore_index=-100,
            reduction="none")
        C = lab.shape[1] // 2
        out["chunk_means"] = [
            float(tok[:, c * C:(c + 1) * C].sum()
                  / (lab[:, c * C:(c + 1) * C] != -100).sum())
            for c in range(2)]
    dist.destroy_process_group()
    return out


# ------------------------------------------------------------------ MoE
def _moe(weights, gate, moe_group=None, training=False, **kw):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ExpertLayer, MoELayer)

    n = sum(1 for k in weights if k.endswith("htoh4.weight"))
    d_model, d_hidden = weights["experts.0.htoh4.weight"].shape
    experts = [ExpertLayer(d_model, d_hidden) for _ in range(n)]
    moe = MoELayer(d_model, experts, gate=gate, moe_group=moe_group, **kw)
    moe.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()
                        if k in moe.state_dict()})
    moe.train() if training else moe.eval()
    return moe


def _moe_run(moe, x, aux=0.0, wrap=None):
    import paddle_tpu_torch as paddle

    net = wrap(moe) if wrap else moe
    out = net(paddle.to_tensor(x))
    loss = out.pow(2).mean()
    if aux and moe.gate.has_loss:
        loss = loss + aux * moe.gate.get_loss()
    loss.backward()
    grads = {k: _np(p.grad) for k, p in moe.named_parameters()
             if p.grad is not None}
    return _np(out), float(loss.numpy()), grads


def _expert(p):
    return getattr(getattr(p, "_value", p), "no_sync", False)


def moe_cases(data):
    """Two ranks of one ``dp`` 2 mesh, the MoE layer expert-parallel over
    ``dp`` (``fleet``'s data-parallel group, as the JAX test names it):
    this rank's half of the tokens through naive top-2 (eval) and gshard
    top-2 in training with ``random_routing=False`` (the data's capacity
    rates), each wrapped in ``DataParallel``; the MoE grad clip's factor
    on the gshard gradients."""
    import paddle_tpu_torch.distributed as tdist
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, GShardGate)

    dist = _init()
    rank = dist.get_rank()
    hcg = _fleet(dp=2)
    group = hcg.get_data_parallel_group()
    x = data["x"]
    half = x.shape[0] // 2
    xs = x[rank * half:(rank + 1) * half]
    out = {"rank": rank}
    naive = {"type": "naive", "top_k": 2}
    moe = _moe(data["weights"], naive, moe_group=group)
    out["naive"] = _moe_run(moe, xs, wrap=tdist.DataParallel)
    out["local_experts"] = sorted(
        {k.split(".")[1] for k in moe.state_dict() if k.startswith("experts")})

    n = sum(1 for k in data["weights"] if k.endswith("htoh4.weight"))
    gate = GShardGate(x.shape[-1], n, 1,
                      capacity=tuple(data["gshard_cap"]),
                      random_routing=False)
    moe = _moe(data["gshard_weights"], gate, moe_group=group, training=True)
    out["gshard"] = _moe_run(moe, xs, aux=0.01, wrap=tdist.DataParallel)
    pg = [(p, p.grad) for p in moe.parameters()]
    clip = ClipGradForMOEByGlobalNorm(1e-3, is_expert_param_func=_expert,
                                      moe_group=group)
    clipped = clip(pg)
    g, c = pg[0][1]._value.reshape(-1), clipped[0][1]._value.reshape(-1)
    i = int(g.abs().argmax())
    out["clip_factor"] = float(c[i] / g[i])
    dist.destroy_process_group()
    return out
