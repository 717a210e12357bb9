"""``python -m paddle_tpu_torch.bench --small --device cpu`` for ``gpt``,
``yoloe`` and ``ocr`` each prints its one JSON line
(``paddle_tpu_torch/bench.py``): the root bench's metric name, the
config, finite losses, and for the bucketed streams the shape and
program counts (every program within the ladders' product, fewer than
the stream's distinct shapes). Port only: the JAX benches time a TPU.
"""
import json

import numpy as np
import pytest

from paddle_tpu_torch import bench
from torch_facade_common import on_cpu  # noqa: F401
from torch_nn_common import one_thread  # noqa: F401


@pytest.mark.parametrize("model,metric", [
    ("gpt", "gpt_tokens_per_sec_per_chip"),
    ("yoloe", "yoloe_images_per_sec_per_chip"),
    ("ocr", "ocr_images_per_sec_per_chip")])
def test_small_bench_emits_its_line(model, metric, capsys):
    bench.main(["--model", model, "--small", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["metric"] == metric and rec["value"] > 0
    assert rec["device"] == "cpu" and np.isfinite(rec["loss"])
    if model == "gpt":
        assert rec["config"] == "gpt-h256-l4-b4-s256-bf16"
        assert rec["compile_counts"]["signatures"] == 1
    else:
        assert rec["stream_batches"] == 8
        assert 0 < rec["recompiles"] <= rec["max_programs"]
        assert rec["recompiles"] < rec["distinct_input_shapes"]
        assert rec["config"].endswith("-bf16-bucketed")
