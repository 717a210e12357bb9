"""The profilers' busy time and idle share (``paddle_tpu_torch.tools``):
the union of device intervals inside the profiled window."""
from types import SimpleNamespace

import pytest
import torch

from paddle_tpu_torch.tools import device_busy

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _evt(name, start_us, end_us, device=CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


@pytest.mark.parametrize("events, busy_ms", [
    ([], 0.0),
    # disjoint kernels add up
    ([_evt("a", 0, 1000), _evt("b", 3000, 4500)], 2.5),
    # overlapping and nested kernels count each instant once, in any order
    ([_evt("b", 500, 2000), _evt("a", 0, 1000), _evt("c", 600, 700),
      _evt("d", 2000, 2500)], 2.5),
    # host events, annotations and excluded ranges span kernels: left out
    ([_evt("a", 0, 1000), _evt("step", 0, 9000, device=CPU),
      _evt("ann", 0, 9000, annotation=True),
      _evt("optimizer.step", 0, 9000)], 1.0),
])
def test_busy_is_the_union_of_device_intervals(events, busy_ms):
    busy, idle = device_busy(events, 10.0, exclude=("optimizer.step",))
    assert busy == pytest.approx(busy_ms)
    assert idle == pytest.approx(1.0 - busy_ms / 10.0)


def test_busy_beyond_the_window_raises():
    with pytest.raises(RuntimeError, match="exceeds"):
        device_busy([_evt("a", 0, 4000), _evt("b", 5000, 9000)], 7.5)


@pytest.mark.parametrize("kernel, group", [
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<128>(...)",
     "flash_fwd"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 128>(...)",
     "flash_fwd"),
    ("void (anonymous namespace)::flash_dq_kernel<__nv_bfloat16, 128>(...)",
     "flash_dq"),
    ("void (anonymous namespace)::flash_dq_kernel<float, 128>(...)",
     "flash_dq"),
    ("void (anonymous namespace)::flash_dq_bf16_kernel<128>(...)",
     "flash_dq"),
    ("void (anonymous namespace)::flash_dkv_bf16_kernel<64>(...)",
     "flash_dkv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm"),
    ("elementwise_kernel", "other"),
])
def test_profile_train_groups_flash_kernels(kernel, group):
    """Each flash kernel, f32 or bf16 form, falls in its own group."""
    from paddle_tpu_torch.tools.profile_train import _group

    assert _group(kernel, ()) == group


@pytest.mark.parametrize("mangled, label", [
    ("_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16"
     "6Layouti", "flash_fwd_bf16_kernel<128>"),
    ("_ZN50_GLOBAL__N__af27cb8_18_flash_attention_cu_5326155221flash_dkv_"
     "bf16_kernelILi64EEEvPK13__nv_bfloat16", "flash_dkv_bf16_kernel<64>"),
    ("_ZN12_GLOBAL__N_115flash_dq_kernelIfLi32EEEvPKT_6Layouti",
     "flash_dq_kernel<f32, 32>"),
    ("_Z22paged_attention_kernelI13__nv_bfloat16S0_EvPKT_PKT0_Pf",
     "paged_attention_kernel<bf16, bf16>"),
    ("_Z22paged_attention_kernelI13__nv_bfloat16aEvPKT_PKT0_Pf",
     "paged_attention_kernel<bf16, int8>"),
    ("_ZN12_GLOBAL__N_122paged_attention_kernelI13__nv_bfloat16S1_EEvPKT_"
     "PKT0_Pf", "paged_attention_kernel<bf16, bf16>"),
    ("_ZN12_GLOBAL__N_120flash_dq_bf16_kernelILi128EEEvPK13__nv_bfloat16"
     "S3_S3_S3_PKfS5_S5_PS1_NS_6LayoutEiiififfi",
     "flash_dq_bf16_kernel<128>"),
    ("_ZN12_GLOBAL__N_122paged_attention_kernelIf13__nv_bfloat16Li1ELi8EEEv"
     "PKT_PKT0_S7_PKfS9_PKiSB_PS2_Pfiiiiiiiif",
     "paged_attention_kernel<f32, bf16, 1, 8>"),
    ("_ZN12_GLOBAL__N_122paged_attention_kernelI13__nv_bfloat16aLi2ELi16EEE"
     "vPKT_PKT0_S7_PKfS9_PKiSB_PS2_Pfiiiiiiiif",
     "paged_attention_kernel<bf16, int8, 2, 16>"),
    ("_ZN12_GLOBAL__N_118paged_merge_kernelIfEEvPKfPT_iii",
     "paged_merge_kernel<f32>"),
    ("_Z12adamw_kernelPfS_", "adamw_kernel"),
    ("not_mangled", "not_mangled"),
])
def test_chip_smoke_labels_ptxas_kernels(mangled, label):
    """chip_smoke.py names each kernel of the build's ptxas report."""
    import chip_smoke

    assert chip_smoke.kernel_label(mangled) == label


def test_profile_serve_counts_k4_merge_in_k4():
    """K4's time a step is its attention kernel and its merge pass
    together; other kernels stay out."""
    from paddle_tpu_torch.tools.profile_serve import k4_time

    rows = [
        ("void (anonymous namespace)::paged_attention_kernel<float, "
         "__nv_bfloat16, 1, 8>(...)", 1.5, 12.0),
        ("void (anonymous namespace)::paged_merge_kernel<float>(...)", 0.25,
         12.0),
        ("sm90_xmma_gemm_f32f32_f32f32", 2.0, 84.0),
        ("elementwise_kernel", 0.5, 100.0),
    ]
    assert k4_time(rows) == (pytest.approx(1.75), pytest.approx(24.0))
    assert k4_time(rows[2:]) == (0, 0)
