"""clipa_tpu_torch.tools: the profile summary's arithmetic (the trace itself
needs a card; see tools/profile_service.py)."""

import pytest

from clipa_tpu_torch.tools import profile_service


@pytest.mark.parametrize("intervals,total", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),                 # overlap counted once
    ([(5, 6), (0, 2), (5.5, 5.7)], 3.0),     # unsorted, nested
    ([(0, 1), (1, 2)], 2.0),                 # touching
])
def test_union_of_device_intervals(intervals, total):
    assert profile_service.union_us(intervals) == total


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::fused_attention_fwd_kernel<80, 96>",
     "attention kernel"),
    ("void (anonymous namespace)::attention_bwd_dkv_kernel<64>(...)",
     "attention bwd kernel"),
    ("void (anonymous namespace)::column_sum_kernel(...)",
     "attention bwd kernel"),
    ("void (anonymous namespace)::flash_attention_fwd_kernel<64>(...)",
     "flash attention kernel"),
    ("void (anonymous namespace)::flash_attention_dq_kernel<64>(...)",
     "flash attention bwd kernel"),
    ("void (anonymous namespace)::flash_attention_dkv_kernel<80>(...)",
     "flash attention bwd kernel"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>", "gemm"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<float, float>", "layernorm"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "GeluCUDAKernelImpl>", "gelu"),
    ("Memcpy HtoD (Pinned -> Device)", "host<->device copy"),
    ("void at::native::reduce_kernel<512, 1>", "other"),
])
def test_kernel_families(name, fam):
    assert profile_service.family(name) == fam
