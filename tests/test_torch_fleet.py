"""``tools/serve_fleet.py``'s drills on the CPU.

Each drill of the fleet tool (the JAX chaos tool's scenarios 7 and 9-20
and the multi-model completion drill) but the two that time themselves
(scenarios 9 and 19, which ``chip_smoke.py`` runs on the card) runs on
port engines at the JAX drills' widths (``tests/test_router.py``'s tiny Llama and a tiny GPT,
f32 pages of 4) with the plain paged attention; on the card
``chip_smoke.py`` runs them at full width, graphed. A drill raises
``DrillFailed`` on any check of its JAX counterpart's.
"""
import pytest
import torch

from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.tools import serve_fleet
from torch_router_common import GPT, LLAMA
from torch_router_common import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fleet():
    model = LlamaForCausalLM(llama_tiny(**LLAMA), device="cpu", seed=3)
    gpt = GPTForCausalLM(gpt_tiny(**GPT), device="cpu", seed=4)
    return serve_fleet.Fleet(model, torch.device("cpu"),
                             kv_dtype=torch.float32, page_size=4, scale=1,
                             gpt=gpt, restart_size="tiny", fuzz_iters=40)


# the two drills whose checks read wall-clock latencies (queue waits,
# TTFT attainment under a latency storm) run on the card only: on a CPU
# shared with other test processes their timings are the neighbours'
TIMED = ("router-least-loaded-dispatch", "brownout-under-burst")


@pytest.mark.parametrize("name", [n for n in serve_fleet.DRILLS
                                  if n not in TIMED])
def test_fleet_drill_on_cpu(fleet, name):
    rec = serve_fleet.run_drills(fleet, [name],
                                 log=lambda _msg: None)[name]
    assert rec["nvcc_runs"] == 0 and fleet.made == []
    if name.startswith(("kill-engine", "prefix-cache", "flight")):
        assert rec["migrations"] == 2
    if name == "kill-serving-process-mid-decode":
        assert rec["recover_nvcc_runs"] == 0 and rec["resumed"] >= 1
    if name == "autoscale-under-burst":
        assert rec["nvcc_runs_after_warm"] == 0
