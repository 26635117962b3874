"""The profile tools' kernel grouping: each of the port's CUDA kernels, by
the name of its ``__global__`` function as the profiler reports it, and
the library's kernel families land in their group."""

import pytest

from x3d_tpu_torch.tools import profile_training
from x3d_tpu_torch.tools.trace import family


@pytest.mark.parametrize("name, want", [
    ("void dw_conv3d_fwd_kernel<float>(float const*, float const*)",
     "port kernels"),
    ("void dw_bn_act_conv_fwd_kernel<__nv_bfloat16>(...)", "port kernels"),
    ("sum_partials_kernel(float const*, float*, int, int)", "port kernels"),
    ("void (anonymous namespace)::dw_bn_act_conv_fwd_ring_kernel<"
     "__nv_bfloat16, 2, 3>(...)", "port kernels"),
    ("(anonymous namespace)::dw_bn_act_conv_fwd_sum_kernel(float const*, "
     "float*, float const*, float*, int, int)", "port kernels"),
    ("void pw_conv_kernel<float>(...)", "port kernels"),
    ("(anonymous namespace)::pw_conv_mma_kernel(__nv_bfloat16 const*, ...)",
     "port kernels"),
    ("void dw_conv3d_pbwd_kernel<float>(...)", "port kernels"),
    ("void (anonymous namespace)::dw_conv3d_dx_phase_kernel<__nv_bfloat16, "
     "2, 3>(...)", "port kernels"),
    ("sum_pbwd_partials_kernel(float const*, float*, int, int, int)",
     "port kernels"),
    ("void (anonymous namespace)::dw_conv3d_pbwd_temporal_kernel<float, "
     "4, 3>(...)", "port kernels"),
    ("(anonymous namespace)::dw_conv3d_pbwd_sum_kernel(float const*, "
     "float*, int, int)", "port kernels"),
    ("void (anonymous namespace)::dw_conv3d_dk_ring_kernel<__nv_bfloat16, "
     "2, 3, 2>(...)", "port kernels"),
    ("(anonymous namespace)::dw_conv3d_dk_sum_kernel(float const*, float*, "
     "int, int)", "port kernels"),
    ("void pw_stats_kernel<float, false>(...)", "port kernels"),
    ("void (anonymous namespace)::pw_conv_stats_mma_kernel<16, 24>(...)",
     "port kernels"),
    ("void (anonymous namespace)::pw_act_conv_stats_mma_kernel<4, 8>(...)",
     "port kernels"),
    ("void (anonymous namespace)::pw_conv_mma_kernel<8, 16>(...)",
     "port kernels"),
    ("void (anonymous namespace)::pw_conv_wg_kernel<216, 1>(CUtensorMap_st, "
     "...)", "port kernels"),
    ("void fma_chain_bf16_kernel<8>(...)", "port kernels"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
    ("void cudnn::ops::convolve_kernel<...>", "cudnn conv"),
    ("void at::native::reduce_kernel<512, 1>(...)", "reduction"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4>(...)",
     "elementwise"),
    ("some_unknown_kernel", "other"),
])
def test_family(name, want):
    assert family(name) == want


@pytest.mark.parametrize("name, want", [
    ("void dw_conv3d_fwd_kernel<__nv_bfloat16>(...)", "K1 depthwise_conv3d"),
    ("void (anonymous namespace)::dw_conv3d_fwd_temporal_kernel<"
     "__nv_bfloat16, 8, 5>(...)", "K1 depthwise_conv3d"),
    ("void (anonymous namespace)::dw_conv3d_fwd_ring_kernel<__nv_bfloat16, "
     "2, 3, 2>(...)", "K1 depthwise_conv3d"),
    ("void dw_bn_act_conv_fwd_kernel<__nv_bfloat16>(...)",
     "K2 dw_bn_act_conv"),
    ("void (anonymous namespace)::dw_bn_act_conv_fwd_ring_kernel<"
     "__nv_bfloat16, 2, 3>(...)", "K2 dw_bn_act_conv"),
    ("(anonymous namespace)::dw_bn_act_conv_fwd_sum_kernel(float const*, "
     "float*, float const*, float*, int, int)", "K2 dw_bn_act_conv"),
    ("void dw_bn_act_conv_bwd_kernel<__nv_bfloat16>(...)",
     "K3 dw_bn_act_conv_bwd"),
    ("void (anonymous namespace)::dw_bn_act_conv_bwd_ring_kernel<"
     "__nv_bfloat16, 2, 3>(...)", "K3 dw_bn_act_conv_bwd"),
    ("(anonymous namespace)::dw_bn_act_conv_bwd_sum_kernel(float const*, "
     "float*, float const*, float*, int, int)", "K3 dw_bn_act_conv_bwd"),
    ("void dw_conv3d_dx_kernel<__nv_bfloat16>(...)",
     "K4 depthwise_conv3d_dx"),
    ("void (anonymous namespace)::dw_conv3d_dx_phase_kernel<__nv_bfloat16, "
     "2, 3>(...)", "K4 depthwise_conv3d_dx"),
    ("void dw_conv3d_dk_kernel<__nv_bfloat16>(...)",
     "K4 depthwise_conv3d_dk"),
    ("sum_dk_partials_kernel(float const*, float*, int, int)",
     "K4 depthwise_conv3d_dk"),
    ("void (anonymous namespace)::dw_conv3d_dk_ring_kernel<__nv_bfloat16, "
     "2, 3, 2>(...)", "K4 depthwise_conv3d_dk"),
    ("(anonymous namespace)::dw_conv3d_dk_sum_kernel(float const*, float*, "
     "int, int)", "K4 depthwise_conv3d_dk"),
    ("void pw_stats_kernel<__nv_bfloat16, true>(...)", "K5/K6 pw_stats"),
    ("void (anonymous namespace)::pw_conv_stats_mma_kernel<16, 24>(...)",
     "K5 pw_conv_stats"),
    ("void (anonymous namespace)::pw_act_conv_stats_mma_kernel<4, 8>(...)",
     "K6 pw_act_conv_stats"),
    ("void (anonymous namespace)::pw_conv_mma_kernel<8, 16>(...)",
     "K7 pw_conv"),
    ("void pw_conv_kernel<float>(...)", "K7 pw_conv"),
    ("void (anonymous namespace)::pw_conv_wg_kernel<96, 2>(CUtensorMap_st, "
     "...)", "K7 pw_conv"),
    ("(anonymous namespace)::pw_conv_mma_kernel(__nv_bfloat16 const*, ...)",
     "K7 pw_conv"),
    ("void dw_conv3d_pbwd_kernel<__nv_bfloat16>(...)",
     "K8 depthwise_conv3d_pbwd"),
    ("sum_pbwd_partials_kernel(float const*, float*, int, int, int)",
     "K8 depthwise_conv3d_pbwd"),
    ("void (anonymous namespace)::dw_conv3d_pbwd_temporal_kernel<"
     "__nv_bfloat16, 8, 5>(...)", "K8 depthwise_conv3d_pbwd"),
    ("(anonymous namespace)::dw_conv3d_pbwd_sum_kernel(float const*, "
     "float*, int, int)", "K8 depthwise_conv3d_pbwd"),
    ("sum_partials_kernel(float const*, float*, int, int)",
     "K2/K3/K5/K6 second passes"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
])
def test_training_group(name, want):
    assert profile_training._group(name) == want
