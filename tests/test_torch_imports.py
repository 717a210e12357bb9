"""paddle_tpu_torch stands alone: no jax, no paddle_tpu, no CPU fallback.

- Importing every module of the port pulls in neither ``jax`` nor
  ``paddle_tpu`` (checked in a fresh interpreter), and no source file of
  the port or ``chip_smoke.py`` names them in an import.
- Entry points given no device run on ``cuda`` and raise without one.
- The kernel build raises, and falls back to nothing, without ``nvcc``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_suite import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax():
    probe = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch\n"
        "names = ['paddle_tpu_torch'] + [m.name for m in pkgutil.walk_packages("
        "paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "bad = [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', "
        "'paddle_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    walked = set(r.stdout.split())
    # the walk saw the package, the training slices' modules included
    assert {f"paddle_tpu_torch.{m}" for m in (
        "amp", "bench", "generator", "models.gpt", "ops.flash_attention",
        "ops.fused_loss", "nn.functional.attention", "nn.layer.norm",
        "optimizer.optimizers", "tools.profile_train", "ops.fused_adamw",
        "tools.bench_adamw", "distributed.fleet.recompute",
        "nn.functional.activation", "serving.adapters", "serving.grammar",
        "tools.serve_tenancy", "metrics", "metrics.registry",
        "metrics.server", "faults", "faults.injection", "faults.watchdog",
        "faults.retry", "faults.deadline", "faults.sanitizer",
        "faults.signals", "serving.tracing", "serving.overload",
        "tools.serve_chaos", "serving.router", "serving.wal",
        "serving.api", "loadgen", "loadgen.trace", "loadgen.driver",
        "loadgen.autoscaler", "loadgen.chaos", "loadgen.restart",
        "tools.serve_fleet", "tensor", "dtypes", "autograd",
        "autograd.engine", "autograd.py_layer", "framework",
        "framework.core_api", "ops._apply", "ops.creation", "ops.math",
        "ops.manipulation", "ops.logic", "ops.stat", "ops.linalg",
        "ops.random", "ops.extras", "tools.op_cases")} <= walked
    # the training sentinel of the JAX package is ported now, with the
    # checkpoint, io, metric and hapi modules of its slice
    assert "paddle_tpu_torch.faults.sentinel" in walked
    assert {f"paddle_tpu_torch.{m}" for m in (
        "framework.io", "distributed.checkpoint", "checkpoint",
        "checkpoint.manager", "checkpoint.state", "io", "io.dataset",
        "io.sampler", "io.dataloader", "metric", "hapi", "hapi.model",
        "hapi.callbacks", "callbacks", "tools.train_chaos")} <= walked


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_sources_name_no_jax_import():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 10
    bad = [f"{f.relative_to(REPO)}:{line} imports {name}"
           for f in files for line, name in _imports(f) if _forbidden(name)]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    """A host without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_unless_told_cpu(no_cuda):
    from paddle_tpu_torch import default_device, resolve_device
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_tiny(vocab_size=32, hidden_size=16, num_layers=1,
                     num_heads=2, max_position_embeddings=16)
    with pytest.raises(RuntimeError):
        default_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        ServingEngine(model, page_size=4)
    # the resilience keywords change nothing about where it runs
    with pytest.raises(RuntimeError):
        ServingEngine(model, page_size=4, device=None, max_queue=2,
                      watchdog_stall_s=1.0, watchdog_recovery_steps=2,
                      engine_id="e", model_id="m")
    engine = ServingEngine(model, page_size=4, device="cpu")
    assert engine.pool.k_pools[0].device.type == "cpu"


def test_pool_and_training_entry_points_need_a_card(no_cuda):
    """``PagedKVCachePool`` without a device resolves to the card, as
    every entry point does; so do the GPT model and the bench."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.serving import PagedKVCachePool

    with pytest.raises(RuntimeError):
        PagedKVCachePool(num_layers=1, num_pages=4, page_size=4,
                         n_kv_heads=1, head_dim=8)
    pool = PagedKVCachePool(num_layers=1, num_pages=4, page_size=4,
                            n_kv_heads=1, head_dim=8, device="cpu")
    assert pool.k_pools[0].device.type == "cpu"
    with pytest.raises(RuntimeError):
        GPTForCausalLM(gpt_tiny(num_layers=1))
    with pytest.raises(RuntimeError):
        bench.bench_gpt13(small=True)
    assert GPTForCausalLM(gpt_tiny(num_layers=1), device="cpu").device.type \
        == "cpu"


def test_llama_training_and_adamw_entry_points_need_a_card(no_cuda):
    """``bench --model llama`` and ``tools.bench_adamw`` resolve to the
    card; ``bench_adamw`` runs on nothing else."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.tools import bench_adamw

    with pytest.raises(RuntimeError):
        bench.bench_llama(small=True)
    with pytest.raises(RuntimeError):
        bench.main(["--model", "llama", "--small"])
    with pytest.raises(RuntimeError):
        bench_adamw.bench_adamw()
    with pytest.raises(RuntimeError):
        bench_adamw.main([])


def test_engine_without_a_device_resolves_to_cuda(monkeypatch):
    """``ServingEngine(device=None)`` with the resilience keywords resolves
    to ``cuda``, as before them: on a host that reports a card, a CPU
    model is refused for living on another device than ``cuda:0``."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_tiny(vocab_size=32, hidden_size=16, num_layers=1,
                     num_heads=2, max_position_embeddings=16)
    model = LlamaForCausalLM(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="engine on cuda:0"):
        ServingEngine(model, page_size=4, max_queue=2, watchdog_stall_s=1.0,
                      watchdog_recovery_steps=2, engine_id="e",
                      model_id="m")


def test_engine_refuses_a_model_on_another_device():
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama_tiny(vocab_size=32, hidden_size=16, num_layers=1,
                     num_heads=2, max_position_embeddings=16)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(model, page_size=4, device="meta")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from paddle_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["paged_attention"])
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("paged_attention")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["flash_attention"])
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["fused_adamw"])
    assert not (tmp_path / "build").exists()


def test_parted_source_compiles_its_parts_then_links(monkeypatch, tmp_path):
    """Every source is compiled as its ``_build.PARTS`` units (``-c
    -DPTC_PART=k``; one unless named there), all started together, then
    linked into its one library; a failed part fails the source and
    leaves no object behind. A stand-in ``nvcc`` records its
    arguments."""
    from paddle_tpu_torch.ops import _build

    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'case "$*" in *PTC_PART=1*) [ -n "$FAIL" ] && exit 3;; esac\n'
        'while [ "$#" -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", os.pathsep.join([str(tmp_path),
                                                os.environ["PATH"]]))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.PARTS == {"paged_attention": 7, "flash_attention": 3}
    secs = _build.build(["paged_attention", "graph_cond"])
    assert set(secs) == {"paged_attention", "graph_cond"}
    lines = calls.read_text().splitlines()
    parts = [ln for ln in lines if "-DPTC_PART=" in ln]
    assert len(parts) == 8
    assert all(" -c " in f" {ln} " and "-shared" not in ln for ln in parts)
    paged = [ln for ln in parts if "paged_attention.cu" in ln]
    assert sorted(ln.split("-DPTC_PART=")[1].split()[0] for ln in paged) \
        == [str(k) for k in range(7)]
    whole = [ln for ln in parts if "graph_cond.cu" in ln]
    assert len(whole) == 1 and "-DPTC_PART=0" in whole[0]
    link = [ln for ln in lines if ln.startswith("-shared")]
    assert sorted(ln.count(".o") for ln in link) == [1, 7]
    # a parted source refuses a build without its part, and names each
    for name, n in _build.PARTS.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "#error" in src and "PTC_PART == -1" not in src
        assert all(f"PTC_PART == {k}" in src for k in range(n))
    for n in secs:
        assert _build.library_path(n).exists()
    assert not list((tmp_path / "build").glob("*.o"))
    # a failed part: the source fails, nothing is left
    monkeypatch.setenv("FAIL", "1")
    monkeypatch.setattr(_build, "library_path",
                        lambda n: tmp_path / "build" / f"lib{n}-x.so")
    with pytest.raises(RuntimeError, match="paged_attention.cu"):
        _build.build(["paged_attention"])
    assert not (tmp_path / "build" / "libpaged_attention-x.so").exists()
    assert not list((tmp_path / "build").glob("*.o"))


def test_router_and_gpt_engine_need_a_card_unless_told_cpu(no_cuda):
    """``Router.add_model`` builds its engines where ``ServingEngine``
    would: ``cuda`` unless the caller asks for the CPU; so does an engine
    over a GPT."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.serving import Router, ServingEngine

    gpt = GPTForCausalLM(gpt_tiny(num_layers=1, vocab_size=64,
                                  max_position_embeddings=32), device="cpu")
    with pytest.raises(RuntimeError):
        ServingEngine(gpt, page_size=4)
    r = Router()
    with pytest.raises(RuntimeError):
        r.add_model("g", gpt, page_size=4)
    assert r.models == []
    assert r.add_model("g", gpt, page_size=4, device="cpu") == ["g/0"]
    assert r.engine("g/0").pool.k_pools[0].device.type == "cpu"
    with pytest.raises(RuntimeError):
        r.add_engine("g", device=None)


def test_restart_child_and_fleet_tool_need_a_card(no_cuda, tmp_path):
    """The restart drill's child runs on ``cuda`` unless told ``--device
    cpu``; the fleet tool runs on nothing else."""
    from paddle_tpu_torch.loadgen import restart
    from paddle_tpu_torch.tools import serve_fleet

    args = ["--wal-dir", str(tmp_path / "w"), "--chunks",
            str(tmp_path / "c"), "--manifest", str(tmp_path / "m")]
    with pytest.raises(RuntimeError):
        restart._main(args)
    with pytest.raises(RuntimeError):
        restart.build_model()
    assert restart.build_model("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError):
        serve_fleet.main([])


def test_facade_entry_points_need_a_card_unless_told_cpu(no_cuda):
    """The Paddle namespace's creation and random ops, ``to_tensor`` and
    ``get_device`` resolve to the card when no device is set; after
    ``set_device("cpu")`` they run on the CPU, and ``set_device(None)``
    goes back to the card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device

    saved = device._current
    device._current = None
    try:
        for make in (lambda: paddle.zeros([2]), lambda: paddle.ones([2]),
                     lambda: paddle.to_tensor([1.0]),
                     lambda: paddle.arange(3), lambda: paddle.randn([2]),
                     lambda: paddle.rand([2]), lambda: paddle.eye(2),
                     paddle.get_device, lambda: paddle.set_device("gpu")):
            with pytest.raises(RuntimeError):
                make()
        paddle.set_device("cpu")
        assert paddle.zeros([2]).place == "cpu"
        assert paddle.get_device() == "cpu"
        paddle.set_device(None)
        with pytest.raises(RuntimeError):
            paddle.zeros([2])
    finally:
        device._current = saved


def test_captured_step_modules_import_no_jax():
    """The modules of the captured training step (``jit/``, the copied
    ``optimizer/lr.py``, ``nn/clip.py``, the optimizers and ``amp``) name
    no jax or paddle_tpu import, and importing them in a fresh interpreter
    loads neither."""
    mods = ["paddle_tpu_torch.jit", "paddle_tpu_torch.jit.static_function",
            "paddle_tpu_torch.optimizer.lr", "paddle_tpu_torch.nn.clip",
            "paddle_tpu_torch.optimizer.optimizers", "paddle_tpu_torch.amp",
            "paddle_tpu_torch.generator"]
    files = [PKG / "jit" / "__init__.py", PKG / "jit" / "static_function.py",
             PKG / "optimizer" / "lr.py", PKG / "nn" / "clip.py"]
    bad = [f"{f.name}:{line} {name}" for f in files
           for line, name in _imports(f) if _forbidden(name)]
    assert all(f.exists() for f in files) and not bad, bad
    probe = ("import importlib, sys\n"
             f"for n in {mods!r}:\n"
             "    importlib.import_module(n)\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu')]\n"
             "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_graphed_bench_and_scaler_need_a_card(no_cuda):
    """``bench.bench_model`` (the ``StaticFunction`` step by default, and
    ``eager=True``), ``bench.main`` and ``amp.GradScaler`` resolve to the
    card and raise without one; given the CPU they run there."""
    from paddle_tpu_torch import amp, bench

    for eager in (False, True):
        with pytest.raises(RuntimeError):
            bench.bench_model("gpt13", small=True, eager=eager)
    with pytest.raises(RuntimeError):
        bench.main(["--small"])
    with pytest.raises(RuntimeError):
        bench.main(["--small", "--eager"])
    with pytest.raises(RuntimeError):
        amp.GradScaler()
    assert amp.GradScaler(device="cpu")._scale.device.type == "cpu"


def test_layer_modules_import_no_jax():
    """The modules of the Layer slice (``nn.layer_base``,
    ``nn.param_attr``, ``nn.initializer``, ``nn.utils``, the layer and
    functional modules, ``models.bert``, ``models._modules``) name no jax
    or paddle_tpu import, and importing them in a fresh interpreter loads
    neither."""
    mods = ["paddle_tpu_torch.nn.layer_base", "paddle_tpu_torch.nn.param_attr",
            "paddle_tpu_torch.nn.initializer", "paddle_tpu_torch.nn.utils",
            "paddle_tpu_torch.nn.layer.common",
            "paddle_tpu_torch.nn.layer.activation",
            "paddle_tpu_torch.nn.layer.container",
            "paddle_tpu_torch.nn.layer.norm", "paddle_tpu_torch.nn.layer.loss",
            "paddle_tpu_torch.nn.layer.transformer",
            "paddle_tpu_torch.nn.functional.common",
            "paddle_tpu_torch.nn.functional.loss",
            "paddle_tpu_torch.nn.functional.norm",
            "paddle_tpu_torch.models.bert", "paddle_tpu_torch.models._modules"]
    files = [PKG / (m[len("paddle_tpu_torch."):].replace(".", "/") + ".py")
             for m in mods]
    files = [f if f.exists() else f.with_suffix("") / "__init__.py"
             for f in files]
    bad = [f"{f.name}:{line} {name}" for f in files
           for line, name in _imports(f) if _forbidden(name)]
    assert all(f.exists() for f in files) and not bad, bad
    probe = ("import importlib, sys\n"
             f"for n in {mods!r}:\n"
             "    importlib.import_module(n)\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu')]\n"
             "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_layers_and_bert_need_a_card_unless_told_cpu(no_cuda):
    """A Layer's parameters and buffers, BERT and its bench resolve to the
    card and raise without one; after ``set_device("cpu")`` they are made
    on the CPU. Nothing falls back."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import bench, device
    from paddle_tpu_torch.models import BertForPretraining, bert_tiny

    saved = device._current
    device._current = None
    try:
        for make in (lambda: paddle.nn.Linear(4, 3),
                     lambda: paddle.nn.BatchNorm1D(4),
                     lambda: paddle.nn.LayerNorm(4),
                     lambda: BertForPretraining(bert_tiny()),
                     lambda: bench.bench_model("bert", small=True)):
            with pytest.raises(RuntimeError):
                make()
        paddle.set_device("cpu")
        assert paddle.nn.Linear(4, 3).weight.place == "cpu"
        assert paddle.nn.BatchNorm1D(4)._mean.place == "cpu"
    finally:
        device._current = saved


def test_vision_and_conv_modules_import_no_jax():
    """``vision`` (its models and ResNet), the conv, pooling and RNN layers
    and the conv and pooling functionals name no jax or paddle_tpu
    import, and importing them in a fresh interpreter loads neither."""
    mods = ["paddle_tpu_torch.vision", "paddle_tpu_torch.vision.models",
            "paddle_tpu_torch.vision.models.resnet",
            "paddle_tpu_torch.nn.layer.conv",
            "paddle_tpu_torch.nn.layer.pooling",
            "paddle_tpu_torch.nn.layer.rnn",
            "paddle_tpu_torch.nn.functional.conv",
            "paddle_tpu_torch.nn.functional.pooling"]
    files = [PKG / (m[len("paddle_tpu_torch."):].replace(".", "/") + ".py")
             for m in mods]
    files = [f if f.exists() else f.with_suffix("") / "__init__.py"
             for f in files]
    bad = [f"{f.name}:{line} {name}" for f in files
           for line, name in _imports(f) if _forbidden(name)]
    assert all(f.exists() for f in files) and not bad, bad
    probe = ("import importlib, sys\n"
             f"for n in {mods!r}:\n"
             "    importlib.import_module(n)\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu')]\n"
             "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_nn_and_vision_export_the_ported_jax_names():
    """``paddle.nn`` has every class of the JAX package's conv, pooling
    and RNN modules and ``paddle.nn.functional`` every functional of its
    conv and pooling modules; ``paddle.vision`` and ``vision.models``
    export every model name of the JAX package's ``vision.models`` (the
    whole zoo is ported), and ``paddle.vision`` the ``ops`` module."""
    import paddle_tpu as pt
    import paddle_tpu_torch as paddle
    from paddle_tpu.nn.functional import conv as jconv, pooling as jpool
    from paddle_tpu.nn.layer import conv, pooling, rnn

    for mod in (conv, pooling, rnn):
        assert all(hasattr(paddle.nn, n) for n in mod.__all__), mod
    for mod in (jconv, jpool):
        assert set(mod.__all__) <= set(paddle.nn.functional.__all__)
    names = set(pt.vision.models.__all__)
    assert set(paddle.vision.models.__all__) == names
    assert set(paddle.vision.__all__) == names | {"models", "ops"}
    assert all(getattr(paddle.vision, n) is getattr(paddle.vision.models, n)
               for n in names)
    assert hasattr(paddle.vision.models, "LeNet")
    assert "vision" in paddle.__all__


def test_resnet_and_its_bench_need_a_card_unless_told_cpu(no_cuda):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import bench, device

    saved = device._current
    device._current = None
    try:
        for make in (lambda: paddle.vision.models.resnet18(),
                     lambda: paddle.nn.Conv2D(3, 4, 3),
                     lambda: paddle.nn.LSTM(4, 5),
                     lambda: bench.bench_model("resnet50", small=True)):
            with pytest.raises(RuntimeError):
                make()
        paddle.set_device("cpu")
        assert paddle.nn.Conv2D(3, 4, 3).weight.place == "cpu"
    finally:
        device._current = saved


_SLICE = ["paddle_tpu_torch.framework.io",
          "paddle_tpu_torch.distributed.checkpoint",
          "paddle_tpu_torch.checkpoint", "paddle_tpu_torch.io",
          "paddle_tpu_torch.faults.sentinel", "paddle_tpu_torch.metric",
          "paddle_tpu_torch.hapi", "paddle_tpu_torch.callbacks",
          "paddle_tpu_torch.serving.router",
          "paddle_tpu_torch.tools.train_chaos"]


def test_checkpoint_and_training_loop_modules_import_no_jax():
    """The checkpoint, sentinel, io, metric and hapi modules and the
    router's reload name no jax, ml_dtypes or paddle_tpu import, and
    importing them (and reaching ``Router.reload``) in a fresh
    interpreter loads none of them."""
    files = [PKG / (m[len("paddle_tpu_torch."):].replace(".", "/") + ".py")
             for m in _SLICE]
    files = [f if f.exists() else f.with_suffix("") / "__init__.py"
             for f in files]
    files += sorted((PKG / "checkpoint").glob("*.py")) + sorted(
        (PKG / "io").glob("*.py")) + sorted((PKG / "hapi").glob("*.py"))
    bad = [f"{f.name}:{line} {name}" for f in files
           for line, name in _imports(f)
           if _forbidden(name) or name.split(".")[0] == "ml_dtypes"]
    assert all(f.exists() for f in files) and not bad, bad
    probe = ("import importlib, sys\n"
             f"for n in {_SLICE!r}:\n"
             "    importlib.import_module(n)\n"
             "from paddle_tpu_torch.serving import Router\n"
             "assert callable(Router.reload)\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')]\n"
             "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_checkpoint_manager_needs_a_card_and_the_loop_is_device_free(
        no_cuda, tmp_path):
    """``CheckpointManager`` (where restored tensors go) and ``paddle.load``
    resolve to the card; ``TrainSentinel``, ``DataLoader`` and ``Model``
    are device-free, as the JAX classes are: they work on what they are
    given (a DataLoader's batches are CPU Tensors, a Model follows its
    network)."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import checkpoint, device, faults, io

    saved = device._current
    device._current = None
    try:
        with pytest.raises(RuntimeError):
            checkpoint.CheckpointManager(str(tmp_path / "a"))
        mgr = checkpoint.CheckpointManager(str(tmp_path / "b"),
                                           device="cpu")
        assert mgr.device.type == "cpu"
        faults.TrainSentinel()
        loader = io.DataLoader(io.TensorDataset([np.ones((4, 2),
                                                         np.float32)]),
                               batch_size=2)
        (x,) = next(iter(loader))
        assert x.place == "cpu"
        with pytest.raises(RuntimeError):
            paddle.nn.Linear(2, 2)
        with device.using_device("cpu"):
            net = paddle.nn.Linear(2, 2)
        model = paddle.Model(net)
        assert model._device.type == "cpu"
        model.prepare(paddle.optimizer.SGD(parameters=net.parameters()),
                      paddle.nn.MSELoss())
        assert np.isfinite(model.train_batch([x], [x])[0])
    finally:
        device._current = saved


_DISTRIBUTED = ["paddle_tpu_torch.distributed",
                "paddle_tpu_torch.distributed.env",
                "paddle_tpu_torch.distributed.store",
                "paddle_tpu_torch.distributed.collective",
                "paddle_tpu_torch.distributed.communication",
                "paddle_tpu_torch.distributed.communication.stream",
                "paddle_tpu_torch.distributed.parallel",
                "paddle_tpu_torch.distributed.misc",
                "paddle_tpu_torch.distributed.spawn",
                "paddle_tpu_torch.distributed.launch",
                "paddle_tpu_torch.distributed.launch.main",
                "paddle_tpu_torch.distributed.topology",
                "paddle_tpu_torch.distributed.sharding_api",
                "paddle_tpu_torch.distributed.fleet",
                "paddle_tpu_torch.distributed.fleet.mp_layers",
                "paddle_tpu_torch.io.dataloader",
                "paddle_tpu_torch.io.shm_channel",
                "paddle_tpu_torch.ops.embedding_grad",
                "paddle_tpu_torch.tools.dist_cases",
                "paddle_tpu_torch.tools.dist_drills"]


def test_distributed_modules_import_no_jax():
    """The modules of the distributed slice (process groups, collectives,
    ``DataParallel``, the mesh, the placements, ``spawn``, ``launch``,
    ``fleet`` and its tensor-parallel layers), the DataLoader's process
    workers and the embedding backward name no jax or paddle_tpu import,
    and importing them in a fresh interpreter loads neither; the package
    walk reaches each of them."""
    files = [PKG / (m[len("paddle_tpu_torch."):].replace(".", "/") + ".py")
             for m in _DISTRIBUTED]
    files = [f if f.exists() else f.with_suffix("") / "__init__.py"
             for f in files]
    files.append(PKG / "csrc" / "embedding_grad.cu")
    assert all(f.exists() for f in files), [f for f in files
                                            if not f.exists()]
    bad = [f"{f.name}:{line} {name}" for f in files if f.suffix == ".py"
           for line, name in _imports(f) if _forbidden(name)]
    assert not bad, bad
    probe = ("import importlib, pkgutil, sys\n"
             f"for n in {_DISTRIBUTED!r}:\n"
             "    importlib.import_module(n)\n"
             "import paddle_tpu_torch\n"
             "assert paddle_tpu_torch.DataParallel is "
             "paddle_tpu_torch.distributed.DataParallel\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu')]\n"
             "assert not bad, bad\n"
             "names = {m.name for m in pkgutil.walk_packages("
             "paddle_tpu_torch.__path__, 'paddle_tpu_torch.')}\n"
             f"missing = set({_DISTRIBUTED[1:]!r}) - names\n"
             "assert not missing, missing\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_distributed_exports_the_jax_names_of_its_parts():
    """``paddle_tpu_torch.distributed`` has every name of the JAX
    package's ``distributed``, the parameter server, ``rpc`` and
    ``auto_parallel`` among them; ``fleet`` has ``fleet.init`` and the
    tensor-parallel layers."""
    import paddle_tpu.distributed as jdist
    import paddle_tpu_torch.distributed as tdist

    missing = set(jdist.__all__) - set(tdist.__all__)
    assert not missing, missing
    assert all(hasattr(tdist, n) for n in tdist.__all__)
    for n in ("init", "distributed_model", "distributed_optimizer",
              "get_hybrid_communicate_group", "ColumnParallelLinear",
              "RowParallelLinear", "VocabParallelEmbedding",
              "ParallelCrossEntropy", "DistributedStrategy", "recompute"):
        assert hasattr(tdist.fleet, n), n


def test_init_parallel_env_needs_a_card_unless_told_cpu(no_cuda):
    """Without a card ``init_parallel_env`` (and so ``DataParallel``)
    raises before it starts any process group."""
    import torch.distributed as tdist

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device

    saved = device._current
    device._current = None
    try:
        with pytest.raises(RuntimeError):
            paddle.distributed.init_parallel_env()
        assert not tdist.is_initialized()
    finally:
        device._current = saved


NEW_DISTRIBUTED = (
    "distributed._wire", "distributed.ps", "distributed.ps.table",
    "distributed.ps.service", "distributed.ps.layers",
    "distributed.ps.communicator", "distributed.rpc", "distributed.rpc.rpc",
    "distributed.auto_parallel", "distributed.fleet.utils",
    "distributed.fleet.role_maker", "distributed.fleet.data_generator",
    "distributed.fleet.elastic", "distributed.fleet.auto",
    "tools.ps_engine_drills")


def test_the_rest_of_distributed_imports_no_jax():
    """The parameter server, ``rpc``, the auto-parallel ``Engine`` and
    fleet's utilities, role makers, data generators and elastic manager,
    imported alone in a fresh interpreter, load neither ``jax`` nor
    ``paddle_tpu``; ``distributed`` and ``fleet`` export them."""
    probe = (
        "import importlib, sys\n"
        f"for n in {NEW_DISTRIBUTED!r}:\n"
        "    importlib.import_module('paddle_tpu_torch.' + n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'paddle_tpu')]\n"
        "assert not bad, bad\n"
        "import paddle_tpu_torch.distributed as d\n"
        "assert {'ps', 'rpc', 'auto_parallel'} <= set(d.__all__)\n"
        "f = d.fleet\n"
        "for n in ('utils', 'data_generator', 'auto', 'util', "
        "'PaddleCloudRoleMaker', 'UserDefinedRoleMaker', 'Role'):\n"
        "    assert hasattr(f, n), n\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_cost_analysis_is_none_before_a_call_and_counts_after():
    """``StaticFunction.cost_analysis``: None before any call; after one,
    the products ``FlopCounterMode`` counted on it (one [2, 4] x [4, 3]
    product forward, the weight's product backward) and no peak bytes
    on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit, nn

    paddle.set_device("cpu")
    try:
        m = nn.Linear(4, 3)
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=m.parameters())

        def step(x):
            loss = m(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        sf = jit.StaticFunction(step)
        assert sf.cost_analysis() is None
        x = paddle.to_tensor(torch.ones(2, 4).numpy())
        sf(x)
        cost = sf.cost_analysis()
        assert cost == {"flops": 2 * 2 * 2 * 4 * 3,
                        "flops_counted": 2 * 2 * 2 * 4 * 3,
                        "flops_kernels": 0, "peak_bytes": None}
        sf(x)  # later calls keep the first call's count
        assert sf.cost_analysis() == cost
        assert sf.cost_analysis(next(iter(sf._cache))) == cost
    finally:
        paddle.set_device(None)


def test_zoo_slice_modules_import_no_jax():
    """The model zoo's slice: every new module is walked by the probe
    (no jax) and names no forbidden import."""
    new = ["vision.ops", "vision.ops_extra", "vision.models.simple_nets",
           "vision.models.mobilenet", "vision.models.extra_nets",
           "vision.models.detection", "vision.models.ocr", "jit.bucketing",
           "tools.zoo_drills"]
    for m in new:
        path = PKG.joinpath(*m.split(".")).with_suffix(".py")
        assert path.exists(), path
        assert not [n for _, n in _imports(path) if _forbidden(n)]
    probe = ("import importlib, sys\n"
             + "".join(f"importlib.import_module('paddle_tpu_torch.{m}')\n"
                       for m in new)
             + "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'paddle_tpu')]\n"
               "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr


# names of the JAX package's exports that the port has not ported yet
JIT_QUEUED = set()


def test_exports_equal_the_jax_packages():
    """``vision.models.__all__`` equals the JAX one; ``jit.__all__`` equals
    it but for the names still queued (``JIT_QUEUED``); ``vision.ops``
    exports the same names."""
    import paddle_tpu as pt
    import paddle_tpu_torch as paddle

    assert paddle.vision.models.__all__ == pt.vision.models.__all__
    assert set(paddle.jit.__all__) == set(pt.jit.__all__) - JIT_QUEUED
    assert not JIT_QUEUED & set(paddle.jit.__all__)
    assert paddle.vision.ops.__all__ == pt.vision.ops.__all__
    for name in paddle.vision.models.__all__:
        assert hasattr(paddle.vision.models, name), name


def test_zoo_entry_points_need_a_card(no_cuda):
    """The zoo's models, ``bench --model gpt|yoloe|ocr``, the drills and
    ``dist_cases.run_cases`` resolve to the card."""
    import inspect

    from paddle_tpu_torch import bench, vision
    from paddle_tpu_torch.tools import dist_cases, zoo_drills

    with pytest.raises(RuntimeError):
        vision.models.mobilenet_v3_small(num_classes=10)
    with pytest.raises(RuntimeError):
        vision.models.ppyoloe_s()
    for model in ("gpt", "yoloe", "ocr"):
        with pytest.raises(RuntimeError):
            bench.main(["--model", model, "--small"])
    with pytest.raises(RuntimeError):
        zoo_drills.run(small=True)
    assert inspect.signature(dist_cases.run_cases).parameters[
        "device"].default == "cuda"


def test_deployment_slice_modules_import_no_jax():
    """The deployment and observability slice: every new module is walked
    by the probe (no jax) and names no forbidden import."""
    new = ["device", "device.cuda", "device.xpu", "inference",
           "inference.config", "inference.predictor", "inference.capi_bridge",
           "profiler", "quantization", "quantization.quanters", "nn.quant",
           "jit.save_load", "hapi.summary", "utils", "utils.flops",
           "regularizer", "version", "sysconfig"]
    for m in new:
        path = PKG.joinpath(*m.split("."))
        path = path / "__init__.py" if path.is_dir() else path.with_suffix(
            ".py")
        assert path.exists(), path
        assert not [n for _, n in _imports(path) if _forbidden(n)]
    probe = ("import importlib, sys\n"
             + "".join(f"importlib.import_module('paddle_tpu_torch.{m}')\n"
                       for m in new)
             + "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'paddle_tpu')]\n"
               "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    src = (PKG / "csrc" / "pd_inference_c.cc").read_text()
    assert "paddle_tpu_torch.inference.capi_bridge" in src
    assert '"paddle_tpu.inference' not in src


# the JAX package's top-level names the port still lacks (ROADMAP Queue 1
# item 16(g)-(k)); the deployment slice ported 24 of the 41 before it,
# the incubate slice ``geometric``, the static slice ``static``,
# ``enable_static`` and ``disable_static``, the export slice ``audio``,
# ``fft``, ``onnx``, ``signal`` and ``text``
TOP_LEVEL_QUEUED = {"cost_model", "dataset", "distribution", "hub",
                    "native", "reader", "sparse"}


def test_export_slice_modules_import_no_jax():
    """The export slice: every new module is walked by the probe (no jax)
    and names no forbidden import."""
    new = ["fft", "signal", "onnx", "onnx.wire", "onnx.convert", "audio",
           "audio.functional", "audio.features", "audio.backends",
           "audio.backends.wave_backend", "audio.datasets", "text",
           "tools.onnx_eval", "tools.export_drills"]
    for m in new:
        path = PKG.joinpath(*m.split("."))
        path = path / "__init__.py" if path.is_dir() else path.with_suffix(
            ".py")
        assert path.exists(), path
        assert not [n for _, n in _imports(path) if _forbidden(n)]
    probe = ("import importlib, sys\n"
             + "".join(f"importlib.import_module('paddle_tpu_torch.{m}')\n"
                       for m in new)
             + "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'paddle_tpu')]\n"
               "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_static_slice_modules_import_no_jax():
    """The static slice: every new module is walked by the probe (no jax)
    and names no forbidden import."""
    new = ["static", "static.record", "static.legacy", "static.nn",
           "static.nn.common", "static.nn.control_flow", "static.nn.rnn",
           "static.nn.sequence_lod", "jit.dy2static", "ops.graph_cond",
           "tools.static_drills"]
    for m in new:
        path = PKG.joinpath(*m.split("."))
        path = path / "__init__.py" if path.is_dir() else path.with_suffix(
            ".py")
        assert path.exists(), path
        assert not [n for _, n in _imports(path) if _forbidden(n)]
    probe = ("import importlib, sys\n"
             + "".join(f"importlib.import_module('paddle_tpu_torch.{m}')\n"
                       for m in new)
             + "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'paddle_tpu')]\n"
               "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert (PKG / "csrc" / "graph_cond.cu").exists()


def test_static_entry_points_need_a_card(no_cuda):
    """``static.Executor()`` and ``static.data`` resolve to the card,
    unless told the CPU; ``Executor("cpu")`` and ``CPUPlace()`` run on
    it."""
    import paddle_tpu_torch as paddle

    with pytest.raises(RuntimeError):
        paddle.static.Executor()
    with pytest.raises(RuntimeError):
        with paddle.static.program_guard(paddle.static.Program()):
            paddle.static.data("x", [2])
    for place in ("cpu", paddle.CPUPlace()):
        assert paddle.static.Executor(place).device.type == "cpu"
    prev = paddle.device._current
    paddle.set_device("cpu")
    try:
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            x = paddle.static.data("x", [2])
            y = x * 2.0
        (out,) = paddle.static.Executor().run(
            main, feed={"x": np.ones(2, np.float32)}, fetch_list=[y])
    finally:
        paddle.device._current = prev
    np.testing.assert_array_equal(out, [2.0, 2.0])


def test_top_level_gap_is_the_queued_names():
    """The ``dir()`` diff of the two packages, each freshly imported (a
    test that imports a submodule adds it to its package's names)."""
    import paddle_tpu as pt
    import paddle_tpu_torch as paddle

    probe = ("import paddle_tpu as pt, paddle_tpu_torch as p\n"
             "print(' '.join(sorted({n for n in dir(pt) if not "
             "n.startswith('_')} - {'annotations'} - set(dir(p)))))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    missing = set(r.stdout.split())
    assert missing == TOP_LEVEL_QUEUED, missing ^ TOP_LEVEL_QUEUED
    for name in ("CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
                 "LazyGuard", "batch", "check_shape", "summary", "flops",
                 "inference", "profiler", "get_cuda_rng_state",
                 "set_printoptions", "is_compiled_with_cuda", "ParamAttr",
                 "loadgen", "regularizer", "version", "sysconfig", "utils"):
        assert name in paddle.__all__, name
    for sub in ("inference", "profiler", "quantization"):
        assert set(getattr(pt, sub).__all__) <= set(
            getattr(paddle, sub).__all__), sub


def test_deployment_entry_points_need_a_card(no_cuda, tmp_path):
    """``create_predictor``, ``jit.load``, ``device.cuda.Stream`` and the
    profiler's GPU target resolve to the card, unless told the CPU."""
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    try:
        lin = paddle.nn.Linear(4, 2)
        prefix = str(tmp_path / "lin")
        paddle.jit.save(lin, prefix, input_spec=[
            paddle.jit.InputSpec([None, 4], "float32")])
    finally:
        paddle.set_device(None)
    cfg = paddle.inference.Config()
    cfg.set_model(prefix)
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError):
        paddle.inference.create_predictor(cfg)
    with pytest.raises(RuntimeError):
        paddle.jit.load(prefix)
    cfg.disable_gpu()
    assert paddle.inference.create_predictor(cfg).run(
        [np.ones((3, 4), np.float32)])[0].shape == (3, 2)
    with pytest.raises(ValueError):
        paddle.device.cuda.Stream()
    with pytest.raises(ValueError):
        paddle.device.cuda.Event()
    with pytest.raises(RuntimeError):
        paddle.profiler.Profiler()
    paddle.profiler.Profiler(targets=[paddle.profiler.ProfilerTarget.CPU])
