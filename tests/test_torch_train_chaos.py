"""``paddle_tpu_torch/tools/train_chaos.py`` on the CPU.

The eight scenarios of the JAX package's ``tools/chaos_train.py``
(``SCENARIOS``: the crash matrix, corruption, preemption, retention,
telemetry, sentinel skip, rollback and abort) on the regression model,
each a case, with its checks exact (bit for bit where the JAX tool's
are). Then the BERT drills that need child processes, at their small
size (``bert_tiny``, B 4) with ``--device cpu``: the fit killed with
SIGKILL mid-epoch and resumed, and the guarded loop preempted by SIGTERM
and resumed, each equal to an uninterrupted child bit for bit.
``chip_smoke.py`` runs the BERT drills at BERT-base's width on the card.
"""
import pytest
import torch

from paddle_tpu_torch import faults
from paddle_tpu_torch.tools import train_chaos
from torch_facade_common import on_cpu  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.mark.parametrize("name", [n for n, _ in train_chaos.SCENARIOS])
def test_regression_scenario(tmp_path, name):
    fn = dict(train_chaos.SCENARIOS)[name]
    rg = train_chaos._Regression("cpu")
    assert fn(rg, str(tmp_path))


def test_run_scenarios_reports_every_scenario():
    logs = []
    assert train_chaos.run_scenarios("cpu", ["retention", "telemetry"],
                                     log=logs.append) == 0
    assert len(logs) == 2 and all("FAIL" not in m for m in logs)


@pytest.mark.parametrize("drill", ["fit-resume", "preemption"])
def test_bert_drill_with_children_at_small_size(tmp_path, monkeypatch, drill):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        recs = train_chaos.run_bert_drills("cpu", small=True, names=[drill],
                                           log=lambda _m: None,
                                           root=str(tmp_path))
    finally:
        torch.set_num_threads(prev)
    rec = recs[drill]
    assert rec["tensors_compared"] > 100
    if drill == "preemption":
        assert 3 <= rec["sigterm_step"] < 9 and rec["losses_compared"] >= 1
    else:
        assert rec["epoch1_losses"] == train_chaos.FIT_STEPS
        assert rec["moments_compared"] > 0
