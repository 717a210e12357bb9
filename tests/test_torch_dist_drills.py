"""The two-rank drills' checks (``tools/dist_drills.py``), on records
made here: a leaf's gradient is held by norm, the weights by their mean
distance in units of lr, each check has a control that must fail it,
and a tolerance exceeded or a control that passes is refused. The drills themselves run on the card
(``chip_smoke.py``'s distributed phase) and, small, with
``python -m paddle_tpu_torch.tools.dist_drills --small --device cpu``."""
import copy

import pytest
import torch

from paddle_tpu_torch.tools import dist_drills as dd


def _rel(mx, over, leaves=292, gap=None):
    r = {"max": mx, "leaf": "gpt.embeddings.weight", "median": mx / 2,
         "min": mx / 4, "over": over, "leaves": leaves}
    if gap is not None:
        r["first_step_gap_lr"] = gap
    return r


def _records():
    launched = {"flash_fwd": 48, "flash_dq": 48, "flash_dkv": 48,
                "paged_attention": 0, "fused_adamw": 0, "embedding_grad": 4,
                "embedding_grad_plain": 0}
    dp = {"losses": [11.03005, 11.02398], "dense_losses": [11.03026,
                                                            11.02891],
          "ranks_unequal": 0, "grads_rel": [_rel(0.0034, 0),
                                            _rel(0.0124, 0)],
          "control_unreduced_rel": _rel(1.1, 292, gap=0.6),
          "master_max_abs": 2.5e-4, "master_mean_abs": 3.2e-7,
          "master_mean_lr": 0.0032, "comm": {}, "step_s": [1.7, 1.2],
          "seconds": 29.0, "loader_position": {}, "first_tokens": [],
          "flash_launches": dict(launched)}
    tp = {"loss": 11.030334, "dense_loss": 11.030263,
          "logits_max_abs": 0.0625, "logits_rel_norm": 0.0153,
          "logits_max": 3.64, "grads_rel": _rel(0.0189, 0),
          "control_unreduced_rel": _rel(1.0, 292, gap=0.5),
          "master_max_abs": 2e-4, "master_mean_abs": 1e-6,
          "master_mean_lr": 0.0103, "tensors_compared": 292,
          "heads_per_rank": 8, "seconds": 10.2,
          "flash_launches": dict(launched)}
    r0 = {"rank": 0, "collectives": {"cases": 25, "failed": [],
                                     "seconds": 0.1}, "dp": dp, "tp": tp}
    r1 = copy.deepcopy(r0)
    r1["rank"] = 1
    r1["dp"]["losses"] = [11.03047, 11.03370]
    return {0: r0, 1: r1}


def test_card_readings_hold():
    out = dd.check(_records(), "cuda")
    assert out["dp"]["grads_rel"][1]["max"] == 0.0124
    assert out["flash_launches"]["train_dp2_gpt355m"]["embedding_grad"] == 8


@pytest.mark.parametrize("path,key,value,said", [
    ("dp", "grads_rel", [_rel(0.0034, 0), _rel(0.05, 3)],
     "dp step 2 gradients: 3 of 292"),
    ("dp", "control_unreduced_rel", _rel(0.01, 0, gap=0.6),
     "a control must fail the check"),
    ("dp", "control_unreduced_rel", _rel(1.1, 292, gap=0.01),
     "the weights' check could not see it"),
    ("tp", "master_mean_lr", 0.2, "tp: master weights 0.2 lr apart"),
    ("tp", "grads_rel", _rel(0.06, 1), "tp gradients: 1 of 292"),
    ("tp", "control_unreduced_rel", _rel(0.02, 0, gap=0.5),
     "a control must fail the check"),
    ("tp", "loss", 11.031, "tp: loss"),
    ("dp", "dense_losses", [11.03026, 11.03026], "dp: mean loss"),
    ("dp", "ranks_unequal", 2, "differ between the ranks"),
])
def test_a_fault_or_a_blind_control_is_refused(path, key, value, said):
    recs = _records()
    recs[0][path][key] = value
    with pytest.raises(dd.DrillFailed, match=said):
        dd.check(recs, "cuda")


def test_a_kernel_that_never_launched_is_refused_on_the_card():
    recs = _records()
    recs[1]["tp"]["flash_launches"]["embedding_grad"] = 0
    with pytest.raises(dd.DrillFailed, match="rank 1 tp"):
        dd.check(recs, "cuda")
    dd.check(recs, "cpu")  # the CPU runs the plain versions


def test_rel_holds_each_leaf_by_norm():
    a = {"w": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0])}
    b = {"w": torch.tensor([3.0, 4.5]), "b": torch.tensor([1.0, 0.0])}
    r = dd._rel(a, b, 0.05)
    assert r["leaf"] == "w" and r["over"] == 1 and r["min"] == 0.0
    assert r["max"] == pytest.approx(0.5 / float(torch.tensor([3.0, 4.5])
                                                 .norm()))
    with pytest.raises(dd.DrillFailed, match="other leaves"):
        dd._rel(a, {"w": b["w"]}, 0.05)
