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

import pytest
import torch

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
        "tools.serve_chaos")} <= walked
    # the training sentinel of the JAX package is not ported
    assert "paddle_tpu_torch.faults.sentinel" not in walked


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
